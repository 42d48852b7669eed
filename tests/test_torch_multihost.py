"""The multi-process helpers (``spotlight_tpu_torch.parallel.multihost``)
against the JAX package's (``tests/test_multihost.py``), on the CPU.

Four gloo ranks of CPU processes (``tests/torch_mesh_worker.py``'s
``multihost_rank_main``, spawned once for the module) join through
``multihost.initialize`` over TCP on a free local port: ``is_primary`` is
true on rank 0 only (and in a process with no group);
``global_batch_array`` of each rank's data slice at 2 x 2 is the whole
batch, the values and shape of JAX's over its 8-device mesh; the training
run of JAX's two-process test (MF, LSTM and lazy MF at 2 x 2) is bit for
bit the same ranks' run in a group joined through the file store.
"""

import socket

import jax
import numpy as np
import pytest
import torch.distributed as dist

from spotlight_tpu.parallel import make_mesh as jax_make_mesh
from spotlight_tpu.parallel import multihost as jax_multihost
from spotlight_tpu_torch.parallel import multihost

from tests import torch_mesh_worker as worker

BATCH = np.arange(32, dtype=np.float32).reshape(16, 2)


def free_address():
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return 'localhost:{}'.format(sock.getsockname()[1])


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp('multihost')
    rs = np.random.RandomState(0)
    case = {'address': free_address(), 'batch': BATCH,
            'pairs': (rs.randint(0, 37, 512), rs.randint(0, 53, 512)),
            'sequences': rs.randint(1, 53, size=(128, 6))}
    return worker.run_ranks({'multihost': case}, workdir,
                            target=worker.multihost_rank_main)


def test_is_primary_without_a_group():
    assert not dist.is_initialized()
    assert multihost.is_primary()
    assert jax_multihost.is_primary()


def test_is_primary_on_rank_zero_only(ranks):
    assert [out['primary'] for out in ranks] == [True, False, False, False]
    assert all(out['primary before'] for out in ranks)


def test_global_batch_array_matches_jax(ranks):
    """Each rank passes its data slice (8 of the 16 rows); every rank gets
    JAX's global array."""
    want = np.asarray(jax_multihost.global_batch_array(
        jax_make_mesh(data=2, model=4), BATCH))
    assert len(jax.devices()) == 8
    for out in ranks:
        got = out['global batch']
        assert got.shape == want.shape == (16, 2)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', ['MF', 'LSTM', 'lazy MF'])
def test_tcp_ranks_train_as_the_file_store_ranks(ranks, name):
    for out in ranks:
        worker.assert_same(out['tcp'][name], out['file'][name])
        assert out['tcp'][name][0] == (name == 'lazy MF')
        assert np.isfinite(out['tcp'][name][1])


def test_initialize_reads_the_address_forms(monkeypatch):
    """``'host:port'`` becomes ``tcp://``, an address with a scheme stays,
    and no address reads torchrun's environment (``env://``)."""
    calls = []
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend, **kwargs: calls.append(
                            (backend, kwargs)))
    multihost.initialize('localhost:1234', 2, 1, backend='gloo')
    multihost.initialize('tcp://10.0.0.1:5', backend='gloo')
    multihost.initialize(backend='gloo')
    assert calls == [
        ('gloo', {'init_method': 'tcp://localhost:1234', 'world_size': 2,
                  'rank': 1}),
        ('gloo', {'init_method': 'tcp://10.0.0.1:5'}),
        ('gloo', {'init_method': 'env://'})]
