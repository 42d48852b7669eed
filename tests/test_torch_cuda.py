"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``: a CUDA kernel has no CPU
mode, so without a card each test skips.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version share one score arithmetic (the exact-tie contract
of ``csrc/common.cuh``), so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions
from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
from spotlight_tpu_torch.ops.kernels import ranking, topk
from spotlight_tpu_torch.utils.convert import params_from_jax

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc: the CUDA kernels have no '
                    'CPU mode (run on the card: python3 chip_smoke.py)')
    return torch.device('cuda')


def _operands(seed, batch, num_items, dim, dyadic=False, copies=1,
              item_dtype=torch.float32, device='cuda'):
    rs = np.random.RandomState(seed)
    if dyadic:
        def draw(*shape):
            return (rs.randint(-8, 9, shape) / 8).astype(np.float32)
    else:
        def draw(*shape):
            return rs.randn(*shape).astype(np.float32)
    base = num_items // copies
    items = np.tile(draw(base, dim), (copies, 1))
    bias = np.tile(draw(base) / 8, copies)
    users = draw(batch, dim)
    return (torch.from_numpy(users).to(device),
            torch.from_numpy(items).to(device=device, dtype=item_dtype),
            torch.from_numpy(bias).to(device))


@pytest.mark.parametrize('batch,num_items,dim,width,dtype,dyadic', [
    (100, 5000, 64, 9, torch.float32, False),
    (70, 1000, 32, 130, torch.float32, False),     # two target chunks
    (65, 777, 48, 4, torch.bfloat16, False),       # ragged everywhere
    (1, 64, 64, 1, torch.float32, False),
    (130, 4000, 16, 6, torch.float32, True),       # 200 copies of each row
])
def test_rank_kernels_equal_plain_versions(cuda, batch, num_items, dim,
                                           width, dtype, dyadic):
    users, items, bias = _operands(batch + width, batch, num_items, dim,
                                   dyadic=dyadic, copies=200 if dyadic else 1,
                                   item_dtype=dtype)
    ids = torch.randint(0, num_items, (batch, width),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    ts = ranking.matched_target_scores(users, items, bias, ids)
    assert torch.equal(ts, ranking.matched_target_scores_plain(
        users, items, bias, ids))
    weights = ranking.rank_weights(users, items, bias, ts)
    assert torch.equal(weights, ranking.rank_weights_plain(users, items,
                                                           bias, ts))
    assert bool((weights >= 0.5).all())   # every target tied itself


@pytest.mark.parametrize('k', [1, 10, 34, 134, 256, 300])
@pytest.mark.parametrize('dyadic', [False, True])
def test_topk_kernel_equals_plain_version(cuda, k, dyadic):
    users, items, bias = _operands(k, 70, 5000, 64, dyadic=dyadic,
                                   copies=100 if dyadic else 1)
    got = topk.streaming_topk(users, items, bias, k)
    want = topk.streaming_topk_plain(users, items, bias, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize('k', [7, 130, 600])
def test_topk_kernel_on_an_ascending_catalogue(cuda, k):
    """Scores rise with the id, so every tile beats the whole running
    list: the candidate buffer fills and merges on every tile."""
    num_items = 600
    items = (torch.arange(num_items, dtype=torch.float32) / 64)[:, None]
    items = items.repeat(1, 4).to(cuda)
    users = torch.full((33, 4), 0.25, device=cuda)
    bias = torch.zeros(num_items, device=cuda)
    scores, ids = topk.streaming_topk(users, items, bias, k)
    want = torch.arange(num_items - 1, num_items - 1 - k, -1,
                        dtype=torch.int32, device=cuda)
    assert torch.equal(ids, want.expand(33, k))
    assert torch.equal(scores, topk.streaming_topk_plain(users, items, bias,
                                                         k)[0])


def test_topk_kernel_bf16_and_negative_zero(cuda):
    users, items, bias = _operands(5, 40, 900, 32,
                                   item_dtype=torch.bfloat16)
    got = topk.streaming_topk(users, items, bias, 50)
    want = topk.streaming_topk_plain(users, items, bias, 50)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])

    users = torch.tensor([[1.0], [-1.0]], device=cuda)
    items = torch.tensor([[0.0], [0.0], [1.0]], device=cuda)
    scores, ids = topk.streaming_topk(users, items, torch.zeros(3,
                                                                device=cuda),
                                      3)
    assert ids.tolist() == [[2, 0, 1], [0, 1, 2]]
    assert not torch.signbit(scores[scores == 0]).any()


def test_each_launch_counts_once(cuda):
    users, items, bias = _operands(2, 64, 1000, 32)
    ids = torch.zeros(64, 3, dtype=torch.int64, device=cuda)
    before = (ranking.RANK_WEIGHTS_LAUNCHES, ranking.MATCHED_SCORES_LAUNCHES,
              topk.STREAMING_TOPK_LAUNCHES)
    ts = ranking.matched_target_scores(users, items, bias, ids)
    ranking.rank_weights(users, items, bias, ts)
    topk.streaming_topk(users, items, bias, 20)
    topk.streaming_topk(users, items, bias, topk.SINGLE_LAUNCH_K + 1)
    assert (ranking.RANK_WEIGHTS_LAUNCHES - before[0],
            ranking.MATCHED_SCORES_LAUNCHES - before[1],
            topk.STREAMING_TOPK_LAUNCHES - before[2]) == (1, 1, 3)


def test_cuda_operands_the_kernels_cannot_take_raise(cuda):
    """A CUDA tensor launches the kernel or raises: nothing falls back."""
    users, items, bias = _operands(3, 8, 200, 16)
    ts = torch.zeros(8, 2, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        ranking.rank_weights(users, items.T.contiguous().T, bias, ts)
    wide_users, wide_items, wide_bias = _operands(4, 8, 200, 2048)
    with pytest.raises(ValueError, match='shared memory'):
        ranking.rank_weights(wide_users, wide_items, wide_bias, ts)
    with pytest.raises(ValueError, match='shared memory'):
        topk.streaming_topk(wide_users, wide_items, wide_bias, 10)
    with pytest.raises(ValueError, match='several devices'):
        topk.streaming_topk(users.cpu(), items, bias, 10)


def _models(num_users=300, num_items=3000, dim=32):
    rs = np.random.RandomState(0)
    tree = {name: {'weight': (rs.randint(-64, 65, (rows, dim + 1))
                              / 1024).astype(np.float32)}
            for name, rows in (('user_embeddings', num_users),
                               ('item_embeddings', num_items))}
    train = Interactions(rs.randint(0, num_users, 6000),
                         rs.randint(0, num_items, 6000),
                         num_users=num_users, num_items=num_items)
    test = Interactions(rs.randint(0, num_users, 900),
                        rs.randint(0, num_items, 900),
                        num_users=num_users, num_items=num_items)
    models = []
    for device in ('cuda', 'cpu'):
        model = ImplicitFactorizationModel(embedding_dim=dim, device=device)
        model._initialize(train)
        model._load_params(params_from_jax(model._net, tree))
        models.append(model)
    return models, train, test


def test_metrics_on_the_card_equal_the_cpu(cuda):
    (on_card, on_cpu), train, test = _models()
    for kwargs in ({}, {'train': train}):
        np.testing.assert_allclose(
            evaluation.mrr_score(on_card, test, batch_size=100, **kwargs),
            evaluation.mrr_score(on_cpu, test, batch_size=100, **kwargs),
            rtol=1e-6, atol=0)
        for got, want in zip(
                evaluation.precision_recall_score(on_card, test, k=[1, 10],
                                                  **kwargs),
                evaluation.precision_recall_score(on_cpu, test, k=[1, 10],
                                                  **kwargs)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(on_card.predict(5), on_cpu.predict(5),
                               rtol=1e-6, atol=1e-7)
