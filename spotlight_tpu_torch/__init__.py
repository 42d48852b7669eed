"""spotlight_tpu_torch: the PyTorch and CUDA port of spotlight_tpu.

The port runs on an NVIDIA H100: plain tensor code is PyTorch, and every
kernel the JAX package wrote in Pallas for the TPU becomes a kernel written
by hand for Hopper (``ops/kernels/csrc``).  It mirrors the JAX package's
module paths and is held against it; it never imports JAX or the JAX
package.  It covers the JAX package on one device:

- data: ``Interactions`` and ``SequenceInteractions``, the splits, the
  dataset loaders (MovieLens, goodbooks, Amazon) with their seeded
  stand-ins (``data.fixtures``), the synthetic generators with the native
  Markov walk (``native``, C++ built by ``g++`` at first use), and the
  alias modules of the original library's paths (``datasets``,
  ``interactions``, ``cross_validation``, ``layers``, ``losses``,
  ``sampling``);
- models: ``ImplicitFactorizationModel`` and
  ``ExplicitFactorizationModel`` over ``BilinearNet`` (dense and row-sparse
  lazy-Adam engines), ``ImplicitSequenceModel`` over pooling, CNN, LSTM and
  mixture-of-tastes representations (dense and row-sparse engines), bloom
  embeddings as item or user layers, the seven losses;
- evaluation: ``mrr_score``, ``precision_recall_score``, their sequence
  forms and ``rmse_score``, through the kernels ``rank_weights``,
  ``matched_target_scores``, ``matched_candidate_scores`` and
  ``streaming_topk``; the kernel entry points ``rank_counts``,
  ``reciprocal_ranks_streaming``, ``bloom_gather_sum`` and
  ``multihot_gather_sum``; the lazy engines' row update is the kernel
  ``row_adam``;
- utilities: serialization, resumable result logs (``utils.results``),
  profiling (``utils.profiling``) and a single-device entry point
  (``entry``).

Of the distributed layer (``spotlight_tpu.parallel``), sharded evaluation
is ported (``parallel``: ``make_mesh`` over ``torch.distributed`` ranks,
the row layout, the sharded metric functions, and ``mesh=`` on the
estimators for evaluation); sharded training, checkpoints and the
multi-host helpers are not yet.
"""

__version__ = '0.1.0'


def __getattr__(name):
    """Top-level access to the main estimators and data types."""
    from importlib import import_module

    homes = {
        'ExplicitFactorizationModel': 'spotlight_tpu_torch.factorization',
        'ImplicitFactorizationModel': 'spotlight_tpu_torch.factorization',
        'BilinearNet': 'spotlight_tpu_torch.factorization',
        'ImplicitSequenceModel': 'spotlight_tpu_torch.sequence',
        'Interactions': 'spotlight_tpu_torch.data',
        'SequenceInteractions': 'spotlight_tpu_torch.data',
    }
    if name in homes:
        return getattr(import_module(homes[name]), name)
    raise AttributeError(
        'module {!r} has no attribute {!r}'.format(__name__, name))
