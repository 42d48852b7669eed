"""The port's implicit-MF model against the JAX package's.

A JAX ``ImplicitFactorizationModel(loss='bpr')`` is fitted briefly; its
parameters go through ``params_from_jax`` into the port, and both packages
must then predict alike.  Predictions agree to rtol 1e-5 / atol 1e-6: both
sum the same float32 products, in another order.  Also here: the port's
isolation from JAX, and its refusal to drop to the CPU on its own.
"""

import ast
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.data import random_train_test_split
from spotlight_tpu.factorization import (
    ImplicitFactorizationModel as JaxImplicitModel)
from spotlight_tpu.factorization.representations import (
    BilinearNet as JaxBilinearNet)
from spotlight_tpu_torch.data import Interactions
from spotlight_tpu_torch.factorization import (BilinearNet,
                                               ImplicitFactorizationModel)
from spotlight_tpu_torch.ops.embeddings import (FusedBiasEmbedding,
                                                ScaledEmbedding, ZeroEmbedding)
from spotlight_tpu_torch.utils.convert import params_from_jax

from tests._fixtures import factorization_dataset

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / 'spotlight_tpu_torch'
RTOL, ATOL = 1e-5, 1e-6


def to_port(interactions):
    return Interactions(interactions.user_ids, interactions.item_ids,
                        num_users=interactions.num_users,
                        num_items=interactions.num_items)


@functools.lru_cache(maxsize=None)
def fitted_pair(fused=True):
    """(JAX model, port model holding its parameters, JAX train, JAX test)
    on a small synthetic dataset, fitted for two BPR epochs."""
    interactions = factorization_dataset(num_users=120, num_items=90,
                                         num_interactions=4000)
    train, test = random_train_test_split(
        interactions, random_state=np.random.RandomState(0))
    dim = 16
    jax_rep = port_rep = None
    if not fused:
        jax_rep = JaxBilinearNet(train.num_users, train.num_items, dim,
                                 fused=False)
        port_rep = BilinearNet(train.num_users, train.num_items, dim,
                               fused=False)
    jax_model = JaxImplicitModel(loss='bpr', embedding_dim=dim, n_iter=2,
                                 batch_size=512, representation=jax_rep,
                                 random_state=np.random.RandomState(42))
    jax_model.fit(train)
    port = ImplicitFactorizationModel(loss='bpr', embedding_dim=dim,
                                      representation=port_rep,
                                      random_state=np.random.RandomState(42),
                                      device='cpu')
    port._initialize(to_port(train))
    port._load_params(params_from_jax(
        port._net, jax.tree_util.tree_map(np.asarray, jax_model._params)))
    return jax_model, port, train, test


@pytest.mark.parametrize('fused', [True, False])
def test_predict_matches_jax(fused):
    jax_model, port, train, _ = fitted_pair(fused)
    rs = np.random.RandomState(1)
    for user in (0, 7, train.num_users - 1):
        np.testing.assert_allclose(port.predict(user),
                                   jax_model.predict(user),
                                   rtol=RTOL, atol=ATOL)
    users = rs.randint(0, train.num_users, 50)
    items = rs.randint(0, train.num_items, 50)
    np.testing.assert_allclose(port.predict(users, items),
                               jax_model.predict(users, items),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.predict(3, items),
                               jax_model.predict(3, items),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('fused', [True, False])
@torch.no_grad()
def test_factors_match_jax(fused):
    jax_model, port, train, _ = fitted_pair(fused)
    params = jax_model._params
    matrix, bias = port._net.item_factors()
    want_matrix, want_bias = jax_model._net.item_factors(params)
    np.testing.assert_allclose(matrix.numpy(), np.asarray(want_matrix),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bias.numpy(), np.asarray(want_bias),
                               rtol=RTOL, atol=ATOL)
    ids = np.arange(0, train.num_users, 7)
    np.testing.assert_allclose(
        port._net.user_factors(torch.from_numpy(ids)).numpy(),
        np.asarray(jax_model._net.user_factors(params, jnp.asarray(ids))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        port._score_catalog(ids).numpy(),
        np.asarray(jax_model._net.score_catalog(params, jnp.asarray(ids))),
        rtol=RTOL, atol=ATOL)


@torch.no_grad()
def test_rank_factors_drop_user_bias_and_cache_items():
    _, port, _, _ = fitted_pair(True)
    reprs, matrix, bias, mixtures = port._rank_factors_users(
        np.array([0, 5]))
    assert mixtures is None
    assert reprs.shape == (2, 16) and reprs.dtype == torch.float32
    again = port._rank_factors_users(np.array([1]))
    assert again[1] is matrix and again[2] is bias
    scores = reprs @ matrix.T + bias
    full = port._score_catalog(np.array([0, 5]))
    user_bias = port._net.user_embeddings.weight[[0, 5], 16]
    torch.testing.assert_close(scores + user_bias[:, None], full, rtol=RTOL,
                               atol=ATOL)


@torch.no_grad()
def test_bf16_tables_convert_and_stream_as_bf16():
    jax_net = JaxBilinearNet(20, 30, 8, table_dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_net.init(jax.random.PRNGKey(3)))
    net = BilinearNet(20, 30, 8, table_dtype=torch.bfloat16)
    net.load_state_dict(params_from_jax(net, tree))
    matrix, bias = net.item_factors()
    assert matrix.dtype == torch.bfloat16 and bias.dtype == torch.float32
    want_matrix, want_bias = jax_net.item_factors(
        jax.tree_util.tree_map(jnp.asarray, tree))
    np.testing.assert_array_equal(matrix.float().numpy(),
                                  np.asarray(want_matrix, np.float32))
    np.testing.assert_array_equal(bias.numpy(), np.asarray(want_bias))
    users, items = np.arange(20), np.arange(20) % 30
    np.testing.assert_allclose(
        net(torch.from_numpy(users), torch.from_numpy(items)).numpy(),
        np.asarray(jax_net.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jnp.asarray(users), jnp.asarray(items))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('bad', ['missing_table', 'shape'])
def test_params_from_jax_rejects_foreign_trees(bad):
    net = BilinearNet(4, 5, 3)
    tree = {'user_embeddings': {'weight': np.zeros((4, 4), np.float32)},
            'item_embeddings': {'weight': np.zeros((5, 4), np.float32)}}
    if bad == 'missing_table':
        del tree['item_embeddings']
    else:
        tree['item_embeddings']['weight'] = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError):
        params_from_jax(net, tree)


@torch.no_grad()
def test_embedding_layers_initialise_as_jax():
    generator = torch.Generator().manual_seed(0)
    scaled = ScaledEmbedding(4000, 32, padding_idx=0, generator=generator)
    # N(0, 1) / D, as the JAX package draws it: std 1/32.
    assert abs(float(scaled.weight[1:].std()) - 1 / 32) < 1e-3
    ids = torch.tensor([0, 1, 0])
    looked_up = scaled(ids)
    assert float(looked_up[0].abs().sum()) == 0.0
    assert torch.equal(looked_up[1], scaled.weight[1])
    assert float(ZeroEmbedding(10, 1).weight.abs().sum()) == 0.0

    fused = FusedBiasEmbedding(50, 8, generator=generator,
                               dtype=torch.bfloat16)
    assert fused.table_width == 9
    assert float(fused.weight[:, 8].float().abs().sum()) == 0.0
    assert fused.apply_raw(ids).dtype == torch.bfloat16
    assert fused(ids).dtype == torch.float32


def test_same_random_state_same_parameters():
    train = to_port(fitted_pair(True)[2])
    states = []
    for _ in range(2):
        model = ImplicitFactorizationModel(
            random_state=np.random.RandomState(4), device='cpu')
        model._initialize(train)
        states.append(model._net.state_dict())
    for name, tensor in states[0].items():
        assert torch.equal(tensor, states[1][name])


def test_check_input_matches_jax():
    jax_model, port, train, _ = fitted_pair(True)
    for users, items in ((train.num_users, None), (0, train.num_items),
                         (np.array([0, train.num_users]), np.array([1, 2]))):
        with pytest.raises(ValueError) as port_error:
            port.predict(users, items)
        with pytest.raises(ValueError) as ref_error:
            jax_model.predict(users, items)
        assert str(port_error.value) == str(ref_error.value)
    with pytest.raises(RuntimeError, match='not been fitted'):
        ImplicitFactorizationModel(device='cpu').predict(0)


def test_fit_trains_and_returns_self():
    """``fit`` trains (it raised before the training slice): the epoch
    loss is finite, the parameters move and the item-factor cache of the
    metrics is invalidated."""
    train = to_port(fitted_pair(True)[2])
    model = ImplicitFactorizationModel(loss='bpr', n_iter=2, batch_size=512,
                                       random_state=np.random.RandomState(3),
                                       device='cpu')
    model._initialize(train)
    before = model._net.item_embeddings.weight.detach().clone()
    matrix = model._rank_factors_users(np.array([0]))[1]
    assert model.fit(train) is model
    assert np.isfinite(model._last_epoch_loss)
    assert not torch.equal(model._net.item_embeddings.weight, before)
    assert model._rank_factors_users(np.array([0]))[1] is not matrix


def test_default_device_is_cuda_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ImplicitFactorizationModel()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ImplicitFactorizationModel(use_cuda=False)
    assert ImplicitFactorizationModel(device='cpu')._device.type == 'cpu'


def _port_modules():
    return sorted('.'.join(path.relative_to(PORT_ROOT.parent)
                           .with_suffix('').parts).replace('.__init__', '')
                  for path in PORT_ROOT.rglob('*.py'))


def test_port_imports_without_jax():
    """Every module of the port imports with JAX and the JAX package made
    unimportable."""
    code = ('import importlib, sys\n'
            'sys.modules["jax"] = None\n'
            'sys.modules["spotlight_tpu"] = None\n'
            'for name in {!r}:\n'
            '    importlib.import_module(name)\n'
            'print("ok")\n').format(_port_modules())
    result = subprocess.run([sys.executable, '-c', code],
                            cwd=PORT_ROOT.parent, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == 'ok'


def test_port_sources_name_no_jax():
    paths = sorted(PORT_ROOT.rglob('*.py')) + [PORT_ROOT.parent
                                               / 'chip_smoke.py']
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            for name in names:
                root = name.split('.')[0]
                assert root not in ('jax', 'jaxlib', 'spotlight_tpu'), (
                    '{} imports {}'.format(path, name))


@pytest.mark.parametrize('kwargs', [{'loss': 'hinge2'},
                                    {'negative_sampling': 'popular'}])
def test_unknown_loss_raises(kwargs):
    """A ValueError, not an assert that ``python -O`` would strip."""
    with pytest.raises(ValueError):
        ImplicitFactorizationModel(device='cpu', **kwargs)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the smoke run exits non-zero and prints no result, from
    the checkout and from a directory holding only the script."""
    script = PORT_ROOT.parent / 'chip_smoke.py'
    lone = tmp_path / 'chip_smoke.py'
    lone.write_bytes(script.read_bytes())
    for path in (script, lone):
        result = subprocess.run([sys.executable, str(path)],
                                cwd=path.parent, capture_output=True,
                                text=True, timeout=300,
                                env=dict(os.environ,
                                         CUDA_VISIBLE_DEVICES=''))
        assert result.returncode != 0
        assert 'no CUDA device' in result.stderr
        assert '"ok"' not in result.stdout and '"kernels"' not in (
            result.stdout)
