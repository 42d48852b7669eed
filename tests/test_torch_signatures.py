"""The port's public signatures against the JAX package's, by ``ast``.

For every JAX module with a counterpart in the port, every public function
and the ``__init__`` and public methods of every public class that both
packages define must take the same parameters, in the same order, with the
same defaults (a default named by a module constant is read as the
constant's value, through the package's own imports).  Neither package is
imported.  ``EXEMPT`` names each callable that differs on purpose, with its
reason; a callable exempted for its trailing ``device`` must equal JAX's
once that one parameter is set aside.  ``tests/test_torch_api_surface.py``
holds the names; this file holds what they take.
"""

import ast

import pytest

from tests.test_torch_api_surface import (JAX_ROOT, PORT_ROOT, _modules,
                                          _parse, public_names)

#: The port's own last parameter: where the work runs.
DEVICE = ('the port adds a trailing device= (the card by default, the CPU '
          'when the caller asks); otherwise JAX\'s signature')
#: JAX's modules are functional: methods take the parameter tree.
PARAMS = ('JAX passes the parameter tree to the method (params=); the '
          'port\'s module holds its parameters')
#: Pallas tiling, interpret mode and the score function.
PALLAS = ('Pallas tiling (tile_items, tile_rows, chunk, batch_tile, '
          'table_tile), interpret= and score_fn= of the TPU kernels; the '
          'CUDA kernels size their own launches, run on the card or as '
          'their plain versions on the CPU, and take the mixture count '
          '(num_mixtures / mixture); the matched scores take any ids as '
          'ids and clamp them (JAX\'s callers clip them first)')
#: JAX's PRNG keys.
PRNG = ('a jax.random key; the port draws from a torch.Generator or takes '
        'the drawn permutation')
#: The collectives of a sharded layer or exchange.
MESH = ('JAX names the mesh axis and shard_map supplies its collectives; '
        'the port\'s sharded layers and exchanges take the rank\'s Mesh '
        '(mesh=, or first), whose torch.distributed groups run them')
STREAMING = ('deliberate: the metrics default to streaming=True, where '
             'JAX\'s None means "on a TPU" (ROADMAP.md, deliberate '
             'differences)')
#: The process group's backend.
BACKEND = ('the port adds a trailing backend= (nccl, one card a rank; gloo '
           'for CPU ranks or ranks sharing a card, which NCCL refuses); '
           'jax.distributed picks its own transport')

EXEMPT = {
    ('evaluation.py', 'mrr_score'): STREAMING,
    ('evaluation.py', 'precision_recall_score'): STREAMING,
    ('evaluation.py', 'sequence_mrr_score'): STREAMING,
    ('evaluation.py', 'sequence_precision_recall_score'): STREAMING,
    ('factorization/explicit.py', 'ExplicitFactorizationModel.__init__'):
        DEVICE,
    ('factorization/implicit.py', 'ImplicitFactorizationModel.__init__'):
        DEVICE,
    ('sequence/implicit.py', 'ImplicitSequenceModel.__init__'): DEVICE,
    ('utils/profiling.py', 'trace'): DEVICE,
    ('utils/profiling.py', 'ThroughputMeter.__init__'): DEVICE,
    ('factorization/representations.py', 'BilinearNet.apply_with_negatives'):
        PARAMS,
    ('factorization/representations.py',
     'BilinearNet.apply_with_inbatch_negatives'): PARAMS,
    ('factorization/representations.py', 'BilinearNet.item_factors'): PARAMS,
    ('factorization/representations.py', 'BilinearNet.user_factors'): PARAMS,
    ('factorization/representations.py', 'BilinearNet.score_catalog'):
        PARAMS,
    ('ops/embeddings.py', 'FusedBiasEmbedding.apply_raw'): PARAMS,
    ('sequence/representations.py', 'MixtureLSTMNet.score_catalog'): PARAMS,
    ('sequence/lazy.py', 'lazy_seq_adam_init'): (
        'JAX initialises from the parameter tree (params); the port from '
        'the network, whose item table it splits from the tower'),
    ('ops/kernels/bloom.py', 'bloom_gather_sum'): PALLAS,
    ('ops/kernels/multihot.py', 'multihot_gather_sum'): PALLAS,
    ('ops/kernels/ranking.py', 'rank_weights'): PALLAS,
    ('ops/kernels/ranking.py', 'rank_counts'): PALLAS,
    ('ops/kernels/ranking.py', 'reciprocal_ranks_streaming'): PALLAS,
    ('ops/kernels/ranking.py', 'matched_target_scores'): PALLAS,
    ('ops/kernels/ranking.py', 'matched_candidate_scores'): PALLAS,
    ('ops/kernels/topk.py', 'streaming_topk'): PALLAS,
    ('parallel/evaluation.py', 'sharded_topk'): PALLAS,
    ('parallel/evaluation.py', 'sharded_rank_counts'): PALLAS,
    ('parallel/evaluation.py', 'sharded_rank_weights'): PALLAS,
    ('parallel/evaluation.py', 'sharded_candidate_scores'): PALLAS,
    ('parallel/sharding.py', 'alltoall_lookup'): MESH,
    ('parallel/sharding.py', 'alltoall_capacity_lookup'): MESH,
    ('factorization/representations.py', 'BilinearNet.sharded'): MESH,
    ('ops/sampling.py', 'sample_items_device'): PRNG,
    ('utils/training.py', 'shuffle_and_batch'): PRNG,
    ('parallel/multihost.py', 'initialize'): BACKEND,
    ('utils/training.py', 'place_data'): (
        'JAX places arrays on a mesh (mesh=); the port places them on a '
        'device'),
}

_UNRESOLVED = object()


def _module_path(root, module):
    """The file of a dotted module of ``root``'s package, or None."""
    parts = module.split('.')
    if parts[0] != root.name:
        return None
    base = root.joinpath(*parts[1:])
    for path in (base.with_suffix('.py'), base / '__init__.py'):
        if path.exists():
            return path
    return None


def constants(root, path, seen=()):
    """Top-level names bound to literals in a module, those it imports from
    its own package included."""
    if path in seen:
        return {}
    found = {}
    for node in _parse(path).body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                names = ([target] if isinstance(target, ast.Name)
                         else getattr(target, 'elts', []))
                values = ([node.value] if isinstance(target, ast.Name)
                          else getattr(node.value, 'elts', []))
                for name, value in zip(names, values):
                    try:
                        found[name.id] = ast.literal_eval(value)
                    except (ValueError, TypeError, SyntaxError):
                        pass
        elif isinstance(node, ast.ImportFrom) and node.module:
            source = _module_path(root, node.module)
            if source is not None:
                theirs = constants(root, source, seen + (path,))
                for alias in node.names:
                    if alias.name in theirs:
                        found[alias.asname or alias.name] = theirs[alias.name]
    return found


def _default(node, known):
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError):
        pass
    if isinstance(node, ast.Name) and node.id in known:
        return known[node.id]
    return ast.unparse(node)


def signature(fn, known):
    """[(kind, name, default)] in order; default ``_UNRESOLVED`` when the
    parameter has none."""
    args = fn.args
    positional = args.posonlyargs + args.args
    defaults = ([_UNRESOLVED] * (len(positional) - len(args.defaults))
                + [_default(d, known) for d in args.defaults])
    out = [('positional', a.arg, d) for a, d in zip(positional, defaults)]
    if args.vararg:
        out.append(('*', args.vararg.arg, _UNRESOLVED))
    out += [('keyword', a.arg, _UNRESOLVED if d is None
             else _default(d, known))
            for a, d in zip(args.kwonlyargs, args.kw_defaults)]
    if args.kwarg:
        out.append(('**', args.kwarg.arg, _UNRESOLVED))
    return out


def callables(tree, public):
    """Public functions, and ``__init__`` and public methods of public
    classes, by qualified name."""
    found = {}
    for node in tree.body:
        if getattr(node, 'name', None) not in public:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            found[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and (
                        item.name == '__init__'
                        or not item.name.startswith('_')):
                    found['{}.{}'.format(node.name, item.name)] = item
    return found


def compared(module):
    """{qualified name: (JAX's signature, the port's)} of the callables
    both packages define in ``module``."""
    jax_tree = _parse(JAX_ROOT / module)
    public = public_names(jax_tree)
    jax_known = constants(JAX_ROOT, JAX_ROOT / module)
    port_known = constants(PORT_ROOT, PORT_ROOT / module)
    theirs = callables(jax_tree, public)
    ours = callables(_parse(PORT_ROOT / module), public)
    return {name: (signature(theirs[name], jax_known),
                   signature(ours[name], port_known))
            for name in sorted(theirs.keys() & ours.keys())}


def _ported_modules():
    return [module for module in _modules()
            if (PORT_ROOT / module).exists()]


def test_the_walk_compares_the_ported_modules():
    modules = _ported_modules()
    assert len(modules) == 55
    assert {'parallel/mesh.py', 'parallel/evaluation.py',
            'parallel/sharding.py', 'parallel/training.py',
            'parallel/checkpoint.py', 'parallel/multihost.py',
            'factorization/implicit.py'} <= set(modules)
    assert sum(len(compared(module)) for module in modules) >= 100


@pytest.mark.parametrize('module', _ported_modules())
def test_public_signatures_match_jax(module):
    for name, (want, got) in compared(module).items():
        reason = EXEMPT.get((module, name))
        if reason is DEVICE:
            assert got[-1][1] == 'device', (module, name)
            got = got[:-1]
        elif reason is not None:
            continue
        assert got == want, '{} {}:\n JAX  {}\n port {}'.format(
            module, name, want, got)


def test_initialize_adds_only_the_backend():
    """``multihost.initialize`` is JAX's with one trailing ``backend``."""
    want, got = compared('parallel/multihost.py')['initialize']
    assert got[:-1] == want and got[-1][1] == 'backend'


def test_entry_points_match_the_graft_entry():
    """``entry.py``'s ``entry`` and ``dryrun_multichip`` take
    ``__graft_entry__.py``'s parameters and a trailing ``device``
    (``DEVICE``)."""
    repo = JAX_ROOT.parent
    names = {'entry', 'dryrun_multichip'}
    theirs = callables(_parse(repo / '__graft_entry__.py'), names)
    ours = callables(_parse(PORT_ROOT / 'entry.py'), names)
    assert sorted(theirs) == sorted(ours) == sorted(names)
    for name in names:
        got = signature(ours[name], {})
        assert got[-1][1] == 'device', name
        assert got[:-1] == signature(theirs[name], {}), name


def test_every_signature_exemption_is_still_needed():
    """An exempted callable both packages still define, and whose
    signatures still differ (for ``DEVICE``: by the trailing device
    alone)."""
    for (module, name), reason in EXEMPT.items():
        assert reason
        signatures = compared(module)
        assert name in signatures, (module, name)
        want, got = signatures[name]
        assert got != want, (module, name)


def test_signature_rule():
    tree = ast.parse(
        'from __future__ import annotations\n'
        'A, B = 3, "x"\n'
        'def f(a, b=A, *args, c=None, d=B, **kw): pass\n'
        'class C:\n'
        '    def __init__(self, x=1.0): pass\n'
        '    def g(self): pass\n'
        '    def _h(self): pass\n'
        'def _private(): pass\n')
    known = {'A': 3, 'B': 'x'}
    found = callables(tree, {'f', 'C'})
    assert sorted(found) == ['C.__init__', 'C.g', 'f']
    assert signature(found['f'], known) == [
        ('positional', 'a', _UNRESOLVED), ('positional', 'b', 3),
        ('*', 'args', _UNRESOLVED), ('keyword', 'c', None),
        ('keyword', 'd', 'x'), ('**', 'kw', _UNRESOLVED)]
    assert signature(found['C.__init__'], known)[1] == (
        'positional', 'x', 1.0)
