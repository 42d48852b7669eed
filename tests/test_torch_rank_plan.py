"""The rank pass's launch plan for rows of ragged target widths
(``ranking.rank_launches``) and the wrapper that runs it.

A row holds its real targets first and NaN after them (the streaming MRR's
pads), and the host knows each row's count of targets.  The plan launches
the rank kernel only on the (rows, target chunk) pairs that hold a real
target, rows grouped by their width; these tests hold it to that on the
CPU.  The wrapper itself (``_rank_weights_cuda``)
runs here against a stand-in for the card's library that reads the same
pointers in CPU memory and counts with the plain version, so its row
order, slices and write-back are checked without a card;
``tests/test_torch_cuda.py`` runs it against the kernel.
"""

import ctypes

import numpy as np
import pytest
import torch

from spotlight_tpu_torch.ops.kernels import ranking

DOT_CHUNK, DOT_BLOCK = 128, 64
MIXTURE_CHUNK, MIXTURE_BLOCK = 32, 16


def _ragged_widths(seed, batch, widest):
    """Zipf-like target counts: most rows at 4 or fewer, a few past one
    and two chunks of 128, one at ``widest``."""
    rs = np.random.RandomState(seed)
    widths = np.minimum(widest, 1 + np.floor(rs.pareto(1.1, batch)))
    widths = widths.astype(np.int64)
    head = (widest, min(widest, 257), min(widest, 129))[:batch]
    widths[:len(head)] = head
    rs.shuffle(widths)
    return widths


def _descending(widths):
    return np.sort(widths)[::-1].copy()


def _instantiation(cols, mixtures):
    """Target slots of the kernel's instantiation for a launch of ``cols``
    targets: the narrowest of ``dispatch_rank`` (csrc/ranking.cu)."""
    slots = ((1, 4, 32) if mixtures and mixtures <= 4
             else (1, 32) if mixtures else (1, 2, 4, 8, 16, 32, 64, 128))
    return min(s for s in slots if s >= cols)


def _check_plan(widths, num_targets, chunk, mixtures, block_users):
    ranges = ranking.range_widths(chunk, mixtures or 0)
    launches = ranking.rank_launches(widths, num_targets, chunk, ranges,
                                     block_users)
    launched = {}
    for first, end, start, cols in launches:
        assert start % chunk == 0 and 1 <= cols <= chunk
        assert 0 <= first < end <= len(widths)
        in_chunk = np.clip(widths[first:end] - start, 0, chunk)
        # No launch holds a (row, chunk) without a real target ...
        assert in_chunk.min() > 0, (first, end, start)
        # ... and each takes the narrowest instantiation of its widest row.
        assert cols == in_chunk.max()
        assert (_instantiation(cols, mixtures)
                == _instantiation(in_chunk.max(), mixtures))
        for row in range(first, end):
            launched[row, start] = launched.get((row, start), 0) + 1
    # Every (row, chunk) holding a real target is launched exactly once.
    want = {(row, start) for row, width in enumerate(widths)
            for start in range(0, int(width), chunk)}
    assert set(launched) == want
    assert set(launched.values()) == {1}
    return launches


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('batch,widest', [(2048, 1000), (300, 300),
                                          (64, 129), (1, 200), (700, 40)])
def test_dot_plan_launches_each_target_chunk_once(seed, batch, widest):
    widths = _descending(_ragged_widths(seed, batch, widest))
    launches = _check_plan(widths, widest, DOT_CHUNK, None, DOT_BLOCK)
    # Within a chunk the splits fall on whole blocks of users.
    for first, end, start, _ in launches:
        rows = int((widths > start).sum())
        assert first % DOT_BLOCK == 0
        assert end % DOT_BLOCK == 0 or end == rows


@pytest.mark.parametrize('mixtures', [2, 4, 8])
@pytest.mark.parametrize('batch,widest', [(300, 100), (17, 33), (2048, 5)])
def test_mixture_plan_launches_each_target_chunk_once(mixtures, batch,
                                                      widest):
    widths = _descending(_ragged_widths(mixtures, batch, widest))
    _check_plan(widths, widest, MIXTURE_CHUNK, mixtures, MIXTURE_BLOCK)


def test_plan_counts_the_call_of_the_heavy_tail():
    """2,048 rows, a few past 128 targets and most at 4 or fewer: about one
    pass of each row, against eight of every row for a chunk loop."""
    widths = _descending(_ragged_widths(0, 2048, 1000))
    launches = _check_plan(widths, 1000, DOT_CHUNK, None, DOT_BLOCK)
    row_passes = sum(end - first for first, end, _, _ in launches)
    assert 2048 <= row_passes < 1.1 * 2048
    assert len(launches) < 20


@pytest.mark.parametrize('num_targets', [1, 4, 5, 128, 129, 300])
def test_full_rows_give_the_chunk_loop(num_targets):
    widths = np.full(100, num_targets)
    want = [(0, 100, start, min(DOT_CHUNK, num_targets - start))
            for start in range(0, num_targets, DOT_CHUNK)]
    assert ranking.rank_launches(widths, num_targets, DOT_CHUNK,
                                 ranking.range_widths(DOT_CHUNK, 0),
                                 DOT_BLOCK) == want


@pytest.mark.parametrize('num_targets,mixtures', [(1, None), (4, None),
                                                  (4, 4), (1, 8)])
def test_narrow_targets_give_one_launch_of_every_row(num_targets, mixtures):
    widths = _descending(np.arange(100) % (num_targets + 1))
    chunk = DOT_CHUNK if mixtures is None else MIXTURE_CHUNK
    ranges = ranking.range_widths(chunk, mixtures or 0)
    assert ranking.rank_launches(widths, num_targets, chunk, ranges,
                                 DOT_BLOCK) == [(0, 100, 0, num_targets)]
    assert ranking._launch_plan(widths[::-1].copy(), 100, num_targets,
                                chunk, ranges, DOT_BLOCK) == (
        None, [(0, 100, 0, num_targets)])


def test_calls_without_widths_give_the_chunk_loop():
    ranges = ranking.range_widths(DOT_CHUNK, 0)
    assert ranking._launch_plan(None, 70, 300, DOT_CHUNK, ranges,
                                DOT_BLOCK) == (None, [
                                    (0, 70, 0, 128), (0, 70, 128, 128),
                                    (0, 70, 256, 44)])
    widths = _ragged_widths(0, 300, 300)
    order, launches = ranking._launch_plan(widths, 300, 300, DOT_CHUNK,
                                           ranges, DOT_BLOCK)
    np.testing.assert_array_equal(widths[order], _descending(widths))
    assert launches == ranking.rank_launches(_descending(widths), 300,
                                             DOT_CHUNK, ranges, DOT_BLOCK)


def test_range_widths_follow_the_instantiations():
    assert ranking.range_widths(128, 0) == (4, 8, 16, 32, 64, 128)
    assert ranking.range_widths(16, 0) == (4, 8, 16)
    assert ranking.range_widths(32, 2) == ranking.range_widths(32, 4) == (
        4, 32)
    assert ranking.range_widths(32, 8) == (1, 32)
    assert ranking.range_widths(4, 4) == (4,)


class _CpuLibrary:
    """The card library's rank entry points over CPU memory: each launch
    reads its operands through their pointers and counts with the plain
    version, in half units, into its output."""

    def __init__(self, items, bias, chunk, block_users):
        self.items, self.bias = items, bias
        self.chunk, self.block_users = chunk, block_users
        self.launches = []

    def spotlight_rank_max_targets(self, dim, mixtures):
        return self.chunk

    def spotlight_rank_block_users(self, mixtures):
        return self.block_users

    def spotlight_rank_smem_bytes(self, dim, mixtures):
        return 0

    def spotlight_rank_weights(self, users, items, items_bf16, bias, tscores,
                               half_units, batch, num_items, dim, targets,
                               mixtures, splits, stream):
        assert items == self.items.data_ptr() and bias == self.bias.data_ptr()
        assert not items_bf16 and splits >= 1

        def view(pointer, ctype, shape):
            return np.ctypeslib.as_array(
                ctypes.cast(pointer, ctypes.POINTER(ctype)), shape=shape)

        width = ranking.user_width(dim, mixtures or None)
        weights = ranking.rank_weights_plain(
            torch.from_numpy(view(users, ctypes.c_float,
                                  (batch, width)).copy()),
            self.items, self.bias,
            torch.from_numpy(view(tscores, ctypes.c_float,
                                  (batch, targets)).copy()),
            mixtures or None)
        out = view(half_units, ctypes.c_int32, (batch, targets))
        assert not out.any(), 'the output must come zeroed'
        out[:] = (weights * 2).to(torch.int32).numpy()
        self.launches.append((batch, targets))
        return 0


def _run_wrapper(monkeypatch, users, items, bias, ts, mixtures, chunk,
                 block_users, widths=None):
    lib = _CpuLibrary(items, bias, chunk, block_users)
    monkeypatch.setattr(ranking._build, 'load', lambda name: lib)
    monkeypatch.setattr(ranking, 'stream_handle', lambda device: None)
    monkeypatch.setattr(ranking, '_sm_count', lambda device: 132)
    names = ('RANK_WEIGHTS_ROW_PASSES',
             'MIXTURE_RANK_WEIGHTS_LAUNCHES' if mixtures
             else 'RANK_WEIGHTS_LAUNCHES')
    before = [getattr(ranking, name) for name in names]
    weights = ranking._rank_weights_cuda(users, items, bias, ts, mixtures,
                                         widths)
    moved = [getattr(ranking, name) - b for name, b in zip(names, before)]
    return weights, lib.launches, moved


@pytest.mark.parametrize('mixtures,widest,chunk,block_users', [
    (None, 300, DOT_CHUNK, DOT_BLOCK),
    (None, 40, 16, DOT_BLOCK),              # a narrower chunk (wider D)
    (4, 80, MIXTURE_CHUNK, MIXTURE_BLOCK),
    (8, 40, MIXTURE_CHUNK, MIXTURE_BLOCK),
])
def test_ragged_wrapper_equals_plain_version(monkeypatch, mixtures, widest,
                                             chunk, block_users):
    rs = np.random.RandomState(widest)
    batch, num_items, dim = 150, 400, 4
    users = torch.from_numpy(rs.randn(
        batch, ranking.user_width(dim, mixtures)).astype(np.float32))
    items = torch.from_numpy(rs.randn(num_items, dim).astype(np.float32))
    bias = torch.from_numpy(rs.randn(num_items).astype(np.float32))
    widths = _ragged_widths(widest, batch, widest)
    ids = torch.from_numpy(rs.randint(0, num_items, (batch, widest)))
    pads = torch.arange(widest)[None, :] >= torch.from_numpy(widths)[:, None]
    if mixtures:
        ts = ranking.matched_candidate_scores(users, items, bias, ids,
                                              mixtures)
    else:
        ts = ranking.matched_target_scores(users, items, bias, ids)
    ts = ts.masked_fill(pads, float('nan'))

    weights, launches, moved = _run_wrapper(
        monkeypatch, users, items, bias, ts, mixtures, chunk, block_users,
        widths)
    want = ranking.rank_weights_plain(users, items, bias, ts, mixtures)
    assert torch.equal(weights, want)
    assert bool((weights[pads] == 0).all())
    assert bool((weights[~pads] >= 0.5).all())   # every target tied itself

    plan = ranking.rank_launches(
        _descending(widths), widest, chunk,
        ranking.range_widths(chunk, mixtures or 0), block_users)
    assert launches == [(end - first, cols)
                        for first, end, _, cols in plan]
    row_passes = sum(end - first for first, end, _, _ in plan)
    assert moved == [row_passes, len(plan)]
    assert row_passes < batch * -(-widest // chunk)

    # Without the widths the same rows run every chunk, to the same weights.
    weights, launches, moved = _run_wrapper(
        monkeypatch, users, items, bias, ts, mixtures, chunk, block_users)
    assert torch.equal(weights, want)
    chunks = -(-widest // chunk)
    assert len(launches) == chunks and moved == [batch * chunks, chunks]


def test_wrapper_without_pads_runs_the_chunk_loop(monkeypatch):
    rs = np.random.RandomState(3)
    users = torch.from_numpy(rs.randn(70, 4).astype(np.float32))
    items = torch.from_numpy(rs.randn(300, 4).astype(np.float32))
    bias = torch.from_numpy(rs.randn(300).astype(np.float32))
    ts = ranking.matched_target_scores(
        users, items, bias, torch.from_numpy(rs.randint(0, 300, (70, 130))))
    weights, launches, moved = _run_wrapper(
        monkeypatch, users, items, bias, ts, None, DOT_CHUNK, DOT_BLOCK)
    assert torch.equal(weights, ranking.rank_weights_plain(users, items,
                                                           bias, ts))
    assert launches == [(70, 128), (70, 2)]
    assert moved == [140, 2]


@pytest.mark.parametrize('widths', [[1, 2], [1, 2, 6], [-1, 2, 3]])
def test_widths_outside_the_rows_raise(widths):
    users, items = torch.zeros(3, 4), torch.zeros(10, 4)
    with pytest.raises(ValueError, match='widths must be'):
        ranking.rank_weights(users, items, torch.zeros(10),
                             torch.zeros(3, 5), widths=widths)
