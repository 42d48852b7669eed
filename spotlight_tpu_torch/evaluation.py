"""Ranking evaluation metrics.

Counterpart of ``spotlight_tpu/evaluation.py``: ``mrr_score``,
``precision_recall_score``, ``sequence_mrr_score``,
``sequence_precision_recall_score`` and ``rmse_score`` (the last a mean
over the model's own predictions, in float32 as the JAX package's).  Users
(or sequences) are processed in device batches:

- the streaming path (the default, on every device) never materialises the
  (batch, num_items) score matrix: MRR counts ranks with
  :func:`~spotlight_tpu_torch.ops.kernels.ranking.rank_weights` and
  precision@k takes an over-fetched top-k from
  :func:`~spotlight_tpu_torch.ops.kernels.topk.streaming_topk`, with dot
  scoring or, for mixture-of-tastes sequence models, mixture scoring.  On
  CUDA tensors they launch the hand-written kernels; on CPU tensors their
  plain PyTorch versions run;
- the materialize path (``streaming=False``) scores the batch against the
  catalogue with one matrix product, masks train items to -FLOAT_MAX and
  ranks by sorting, reproducing ``scipy.stats.rankdata``'s average ranks.

Each metric builds its batches, ``(inputs, targets, target mask,
excluded rows, widths)``, and hands them to one loop of its kind:
:func:`_mrr_loop` for the two MRR metrics, :func:`_topk_loop` for the two
precision/recall metrics.  A streaming call scores through one
:class:`_Scorer`, chosen once per call (:func:`_scorer`): its matched
scores of ids, its rank weights and its top-k are the kernels' on one
device, or, on a model with a mesh whose model axis has more than one rank
(:mod:`spotlight_tpu_torch.parallel`), their sharded forms: each rank
streams its block of the catalogue (padded to a multiple of the axis with
rows that never outrank an item) and the ranks' weights are summed or
their top-k lists merged (``parallel.evaluation``).  A model trained on
the mesh hands each rank its own block of the catalogue, and no rank
builds the whole.  Every rank calls the metric alike and returns the same
result, equal to one device's.  The matched target scores, the pads' NaN,
the train correction and the top-k's train compaction are written once,
for both (:func:`_streaming_ranks`, :func:`_streaming_topk_hits`).

Each metric call picks its path once, before any launch (:func:`_route`):
it streams when the caller asks for it, the model gives the kernels
factors (its ``_rank_factor_shape`` is not None), and the kernels take
them (``ranking.streams``, ``topk.streams``: mixtures of at most
``MAX_MIXTURES`` tastes and, on a card, the widths whose blocks fit in
shared memory, the call's widest top-k fetch included).  A call that the
kernels do not take runs whole on the materialize path, at its batch size,
and counts once in :data:`MATERIALIZE_ROUTES`; a model that gives no
factors (a custom network, a model that only predicts) runs there
uncounted.  That is a route chosen up front, not the JAX package's
fallback: nothing here catches a kernel failure to recompute on the
materialize path, and a kernel that fails to build or launch raises.  Each
metric reads its result back to the host once, after the last batch.

Each metric call is one span (``utils.profiling.span``) named after it,
``spotlight.<metric>``, holding ``spotlight.eval.rows`` (the host's rows:
``_eval_rows``, or the sequences' prefixes and excluded rows), one
``spotlight.eval.upload`` a batch (its rows padded to the batch's widest
and placed on the device) and, when it streams, one
``spotlight.eval.factors`` a batch (``_rank_factors``).

The host keeps every metric's rows compact (``_Rows``): each row's count
and the ids of all rows concatenated, O(entries + rows): the users' test
and train rows, and each prefix's distinct items where the sequence
metrics exclude them.  Each batch's padded rows are built on the model's
device, from the batch's real ids and their flat positions sent up in one
pinned copy (``_rows_on``, counted in :data:`ROWS_BUILT_ON_DEVICE` and
:data:`ROW_UPLOAD_BYTES`).  A model on the CPU takes the same path, its
copy a plain one.
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch

from spotlight_tpu_torch.factorization._base import resolve_device
from spotlight_tpu_torch.ops.kernels import ranking, topk
from spotlight_tpu_torch.ops.kernels.ranking import (
    matched_candidate_scores, matched_target_scores, rank_weights)
from spotlight_tpu_torch.ops.kernels.topk import streaming_topk
from spotlight_tpu_torch.parallel.evaluation import (
    _block, candidate_scores_of_block, rank_weights_of_block, topk_of_block)
from spotlight_tpu_torch.utils.profiling import span

FLOAT_MAX = np.finfo(np.float32).max

#: Users per batch on the streaming path.  The JAX package derived its
#: width from the TPU's 16 MB of VMEM; here shared memory sets no cap: the
#: rank and top-k kernels keep 64 dot users (16 mixture users) per block
#: resident, and a wider batch only adds blocks.  What the batch buys is
#: fewer catalogue passes: every batch streams the whole item table once
#: per kernel.  2048 users give the rank kernel 32 user blocks, which with
#: the catalogue splits fill the 132 SMs of an H100 four blocks deep, and
#: keep the top-k scratch (B x splits x KP 8-byte keys, at most 8192 keys a
#: user) at 128 MB.
STREAMING_BATCH = 2048
#: Users per batch on the materialize path, whose (B, N) score matrix and
#: its sort grow with the batch.
MATERIALIZE_BATCH = 256

#: Metric calls that the route query sent to the materialize path because
#: the streaming kernels do not take the model's factors (one per call).
MATERIALIZE_ROUTES = 0
#: Rows of padded (batch, width) id matrices that ``_rows_on`` built on the
#: card from the real ids: one a user for the targets, one more for the
#: train rows where a train set is given, and one a sequence for its
#: excluded items where they are excluded.  Rows built for a model on the
#: CPU count nothing.
ROWS_BUILT_ON_DEVICE = 0
#: Bytes of row data that ``_rows_on`` sent to the card: each real id and
#: its flat position, 4 bytes each (8 for a matrix past 2**31 entries).
#: Nothing is counted for a model on the CPU.
ROW_UPLOAD_BYTES = 0


class _Rows(NamedTuple):
    """Rows of item ids in compact form: each row's count of ids, and the
    ids of all rows concatenated in row order."""

    counts: np.ndarray
    ids: np.ndarray

    @property
    def width(self):
        """The widest row's count, at least 1: the padded matrix's width."""
        return max(int(self.counts.max()) if len(self.counts) else 0, 1)

    def batches(self, batch_size):
        """The ``_Rows`` of each ``batch_size`` rows in turn."""
        offsets = np.concatenate([[0], np.cumsum(self.counts)])
        for start in range(0, len(self.counts), batch_size):
            stop = min(start + batch_size, len(self.counts))
            yield _Rows(self.counts[start:stop],
                        self.ids[offsets[start]:offsets[stop]])


def _csr_rows(csr_matrix, users):
    """``_Rows`` of ``users`` in a CSR matrix: their column indices in the
    matrix's order, in O(their entries + users)."""
    indptr = csr_matrix.indptr
    starts = indptr[users]
    counts = indptr[users + 1] - starts
    offsets = np.repeat(starts - (np.cumsum(counts) - counts), counts)
    return _Rows(counts,
                 csr_matrix.indices[offsets + np.arange(len(offsets))])


def _row_positions(counts, width):
    """The flat position ``row * width + column`` of each id of rows of
    ``counts`` ids, left-aligned in a (len(counts), width) matrix."""
    starts = np.cumsum(counts) - counts
    return np.arange(int(counts.sum())) + np.repeat(
        np.arange(len(counts)) * width - starts, counts)


def _rows_on(parts, device):
    """Each ``_Rows`` of ``parts`` as its padded matrix on ``device``: the
    real ids and their positions go up in one copy (pinned and
    asynchronous to a card), as int32 where every position fits, and the
    device widens them, fills and scatters."""
    global ROWS_BUILT_ON_DEVICE, ROW_UPLOAD_BYTES
    widths = [rows.width for rows in parts]
    largest = max(len(rows.counts) * width
                  for rows, width in zip(parts, widths))
    packed = np.concatenate(
        [array for rows, width in zip(parts, widths)
         for array in (rows.ids, _row_positions(rows.counts, width))],
        dtype=np.int32 if largest <= 2 ** 31 else np.int64)
    flat = ranking._upload(packed, device).long()
    on_card = device.type == 'cuda'
    if on_card:
        ROW_UPLOAD_BYTES += packed.nbytes
    out, offset = [], 0
    for rows, width in zip(parts, widths):
        n = len(rows.ids)
        out.append(torch.full((len(rows.counts) * width,), -1,
                              dtype=torch.int64, device=flat.device)
                   .scatter_(0, flat[offset + n:offset + 2 * n],
                             flat[offset:offset + n])
                   .view(-1, width))
        if on_card:
            ROWS_BUILT_ON_DEVICE += len(rows.counts)
        offset += 2 * n
    return out


def _batched(users_or_rows, batch_size):
    n = len(users_or_rows)
    for start in range(0, n, batch_size):
        yield users_or_rows[start:start + batch_size]


def _compact_train_mask(top_ids, train, k_max):
    """Drop train ids from an over-fetched top list, keeping rank order:
    the reference's demotion of train items to -FLOAT_MAX."""
    masked = (top_ids[:, :, None] == train[:, None, :]).any(dim=2)
    order = torch.argsort(masked.to(torch.int32), dim=1, stable=True)
    return torch.gather(top_ids, 1, order)[:, :k_max]


def _ranks_with_train_correction(weights, num_items, safe_targets,
                                 target_scores, valid_train, safe_train,
                                 train_scores):
    """Closed-form train-mask correction of streaming rank weights.

    A masked item contributes to no target's counts, so its comparison
    weight is subtracted; a target that is itself masked ranks behind every
    unmasked item, tied with the rest of the masked set:
    ``rank = (N - |M|) + (|M| + 1) / 2``.  Targets are compared with the
    train items in chunks, so the (B, T_chunk, Tr) broadcast stays bounded
    for heavy users.
    """
    chunk = 32
    tr_weight_parts, in_train_parts = [], []
    tr_scores = train_scores[:, None, :]
    for start in range(0, safe_targets.shape[1], chunk):
        tgt_ids = safe_targets[:, start:start + chunk, None]
        tgt = target_scores[:, start:start + chunk, None]
        same = safe_train[:, None, :] == tgt_ids
        countable = valid_train[:, None, :] & ~same
        tr_weight_parts.append(torch.where(
            countable & (tr_scores > tgt), 1.0,
            torch.where(countable & (tr_scores == tgt), 0.5, 0.0)).sum(dim=2))
        in_train_parts.append((valid_train[:, None, :] & same).any(dim=2))
    tr_weight = torch.cat(tr_weight_parts, dim=1)
    target_in_train = torch.cat(in_train_parts, dim=1)
    train_count = valid_train.sum(dim=1, keepdim=True)

    unmasked_ranks = weights - tr_weight + 0.5
    masked_ranks = (num_items - train_count) + (train_count + 1.0) * 0.5
    return torch.where(target_in_train, masked_ranks, unmasked_ranks)


def _mean_reciprocal(ranks, target_mask):
    rr = torch.where(target_mask, 1.0 / ranks, 0.0)
    denom = target_mask.sum(dim=1).clamp(min=1)
    return rr.sum(dim=1) / denom


class _Scorer(NamedTuple):
    """One call's three streaming operations, chosen once (:func:`_scorer`).
    Each takes a batch's factors ``(reprs, item_matrix, item_bias,
    mixture)`` as :func:`_rank_factors` gives them (``mixture`` None for
    dot scoring):

    - ``matched(factors, ids)``: (B, T) scores of item ids, bit-equal to
      the catalogue scores that the other two compare;
    - ``weights(factors, target_scores, widths)``: (B, T) rank weights
      (``ranking.rank_weights``), ``widths`` each row's count of real
      targets on the host, or None;
    - ``topk(factors, fetch)``: (B, fetch) top item ids.

    ``num_items`` is the real catalogue's size."""

    num_items: int
    matched: Callable
    weights: Callable
    topk: Callable


def _device_scorer(num_items):
    """The operations on one device, over the whole catalogue of
    ``num_items`` rows: the kernels' own entry points, dot or mixture
    scoring."""

    def matched(factors, ids):
        reprs, item_matrix, item_bias, mixture = factors
        if mixture is None:
            return matched_target_scores(reprs, item_matrix, item_bias, ids)
        return matched_candidate_scores(reprs, item_matrix, item_bias, ids,
                                        mixture)

    def weights(factors, target_scores, widths):
        reprs, item_matrix, item_bias, mixture = factors
        return rank_weights(reprs, item_matrix, item_bias, target_scores,
                            mixture, widths)

    def top_ids(factors, fetch):
        reprs, item_matrix, item_bias, mixture = factors
        return streaming_topk(reprs, item_matrix, item_bias, fetch,
                              mixture)[1]

    return _Scorer(num_items, matched, weights, top_ids)


def _sharded_mesh(model):
    """The model's mesh when its catalogue is sharded (a model axis of more
    than one rank, the JAX package's test), else None.  Every rank holds the
    same model, so every rank takes the same branch: a rank that took
    another would leave the others waiting in a collective."""
    mesh = getattr(model, '_mesh', None)
    if mesh is not None and mesh.shape.get('model', 1) > 1:
        return mesh
    return None


def _pad_catalog_for_shards(mesh, item_matrix, item_bias):
    """The catalogue padded to a multiple of the model axis with rows that
    never outrank a real item: zero vectors with bias -FLOAT_MAX."""
    pad = -item_matrix.shape[0] % mesh.shape['model']
    if pad:
        item_matrix = torch.cat([item_matrix, item_matrix.new_zeros(
            (pad, item_matrix.shape[1]))])
        item_bias = torch.cat([item_bias, item_bias.new_full(
            (pad,), float(-FLOAT_MAX))])
    return item_matrix, item_bias


def _own_block(mesh, num_items, item_matrix, item_bias):
    """This rank's block, as a mesh-trained model hands it out, with the
    rows past the catalogue made pad rows: zero vectors, bias
    -FLOAT_MAX."""
    local_rows = item_matrix.shape[0]
    first = mesh.index('model') * local_rows
    real = min(max(num_items - first, 0), local_rows)
    if real < local_rows:
        item_matrix = item_matrix.clone()
        item_matrix[real:] = 0
        item_bias = item_bias.clone()
        item_bias[real:] = float(-FLOAT_MAX)
    return local_rows, item_matrix, item_bias, first


def _shard_catalog(model, mesh, item_matrix, item_bias):
    """This rank's block ``(local rows, items, bias, first id)`` of the
    catalogue padded as :func:`_pad_catalog_for_shards` pads it, kept on
    the model beside its item factors: the model hands out the same item
    tensor until its parameters change, so a metric pads once a parameter
    version, not once a batch.  A model trained on the mesh, whose item
    table is this rank's block (``_holds_blocks`` of its network), hands
    out that block, whose padded rows are set.  A model that holds the
    whole catalogue on every rank (a loaded model given a mesh again, or a
    replicated item layer that ``sharded`` leaves as it is) is padded and
    its block is a view.  A model moved to a mesh of another model axis
    pads anew."""
    shards = mesh.shape['model']
    cache = getattr(model, '_shard_catalog_cache', None)
    if cache is None or cache[0] is not item_matrix or cache[1] != shards:
        if model._net._holds_blocks():
            block = _own_block(mesh, model._num_items, item_matrix,
                               item_bias)
        else:
            block = _block(mesh, 'model', *_pad_catalog_for_shards(
                mesh, item_matrix, item_bias))
        cache = (item_matrix, shards, block)
        model._shard_catalog_cache = cache
    return cache[2]


def _repeat_first(rows, pad):
    return torch.cat([rows, rows[:1].expand(pad, *rows.shape[1:])])


def _mesh_scorer(model, mesh):
    """The operations over a row-sharded catalogue (``parallel.evaluation``):
    each rank scores its block (:func:`_shard_catalog`), and the ranks'
    matched scores and rank weights are summed and their top-k lists
    merged over the model axis.  The matched scores and the rank weights
    pad the user batch to a multiple of the data axis by repeating its
    first row, so that it splits over the data ranks, and slice their
    result back; the top-k takes the batch as it is.  Every row runs on
    every target chunk: the widths are not used."""

    def block(factors):
        return _shard_catalog(model, mesh, factors[1], factors[2])

    def split(factors, rows):
        reprs = factors[0]
        pad = -len(rows) % mesh.shape.get('data', 1)
        if pad:
            reprs, rows = _repeat_first(reprs, pad), _repeat_first(rows, pad)
        return reprs, rows

    def matched(factors, ids):
        reprs, padded = split(factors, ids)
        return candidate_scores_of_block(
            mesh, reprs, block(factors), padded,
            mixture=factors[3])[:len(ids)]

    def weights(factors, target_scores, widths):
        reprs, padded = split(factors, target_scores)
        return rank_weights_of_block(
            mesh, reprs, block(factors), padded,
            mixture=factors[3])[:len(target_scores)]

    def top_ids(factors, fetch):
        return topk_of_block(mesh, factors[0], block(factors), fetch,
                             mixture=factors[3])[1]

    return _Scorer(model._num_items, matched, weights, top_ids)


def _scorer(model):
    """The call's operations: over the model's mesh where its catalogue is
    sharded, else on its device."""
    mesh = _sharded_mesh(model)
    if mesh is None:
        return _device_scorer(model._num_items)
    return _mesh_scorer(model, mesh)


def _rank_factors(model, kind, inputs):
    """``(reprs, item_matrix, item_bias, mixture)`` from the model's
    ``_rank_factors_users`` (kind 'users', inputs user ids) or
    ``_rank_factors_sequences`` (kind 'sequences', inputs prefixes).
    ``mixture`` is None for dot scoring."""
    factors_fn = getattr(model, '_rank_factors_' + kind)
    with span('spotlight.eval.factors'):
        return factors_fn(inputs)


def _streaming_ranks(scorer, factors, targets, target_mask, excluded=None,
                     widths=None):
    """Per-row mean reciprocal ranks of one batch through the rank kernel:
    matched target scores, the rank weights, then the correction for the
    ``excluded`` rows (-1 pads; None excludes nothing).  ``widths``: each
    row's count of targets, which come first in it, where the host knows
    them."""
    num_items = scorer.num_items
    safe_targets = targets.clamp(0, num_items - 1)
    # The target scores bit-match the kernel's tile scores, so each
    # target's comparison with itself is an exact tie (weight 0.5).
    target_scores = scorer.matched(factors, safe_targets)
    # A pad's score is NaN, which counts nothing: given the rows' widths,
    # the rank kernel scores each row only against the chunks it holds.
    pads_nan = target_scores.masked_fill(~target_mask, float('nan'))
    weights = scorer.weights(factors, pads_nan, widths)
    if excluded is None:
        ranks = weights + 0.5
    else:
        safe_excluded = excluded.clamp(0, num_items - 1)
        ranks = _ranks_with_train_correction(
            weights, num_items, safe_targets, target_scores, excluded >= 0,
            safe_excluded, scorer.matched(factors, safe_excluded))
    return _mean_reciprocal(ranks, target_mask)


def _streaming_topk_hits(scorer, factors, k_max, excluded=None):
    """(B, k_max) top ids of one batch through the top-k kernel, the ids of
    the ``excluded`` rows (-1 pads; None excludes nothing) left out.

    Exclusion over-fetches: the kernel returns the top ``k_max + excluded
    width`` (a row has at most that width of its excluded items in any
    window), excluded ids are compacted out and the first ``k_max``
    survivors kept.
    """
    fetch = k_max if excluded is None else k_max + excluded.shape[1]
    # A fetch of the whole catalogue already holds every unmasked item.
    top_ids = scorer.topk(factors, min(fetch, scorer.num_items))
    if excluded is None:
        return top_ids
    return _compact_train_mask(top_ids, excluded, k_max)


def _mask_scores(scores, mask_indices):
    """Set ``scores[i, mask_indices[i, :]]`` to -FLOAT_MAX; -1 pads."""
    num_items = scores.shape[1]
    safe = torch.where(mask_indices < 0, num_items, mask_indices)
    padded = torch.cat([scores, torch.zeros_like(scores[:, :1])], dim=1)
    padded.scatter_(1, safe, float(-FLOAT_MAX))
    return padded[:, :num_items]


def _reciprocal_ranks(scores, targets, target_mask):
    """Mean reciprocal average-tie rank of the target items of each row."""
    num_items = scores.shape[1]
    sorted_scores = torch.sort(scores, dim=1).values
    target_scores = torch.gather(scores, 1, targets.clamp(0, num_items - 1))
    right = torch.searchsorted(sorted_scores, target_scores, right=True)
    left = torch.searchsorted(sorted_scores, target_scores)
    ranks = (num_items - right) + (right - left + 1) * 0.5
    return _mean_reciprocal(ranks, target_mask)


def _top_items(scores, k):
    """Top-k ids, ties by ascending id (a stable descending sort)."""
    return torch.sort(scores, dim=1, descending=True,
                      stable=True).indices[:, :k]


def _precision_recall_from_topk(top_ids, targets, target_mask, k_values):
    hits = ((top_ids[:, :, None] == targets[:, None, :])
            & target_mask[:, None, :]).any(dim=2).float()
    cum_hits = torch.cumsum(hits, dim=1)
    num_targets = target_mask.sum(dim=1).clamp(min=1)
    precision = torch.stack([cum_hits[:, k - 1] / k for k in k_values],
                            dim=1)
    recall = torch.stack([cum_hits[:, k - 1] / num_targets
                          for k in k_values], dim=1)
    return precision, recall


def _score_user_batch(model, user_batch, device):
    """(B, num_items) scores through the model's catalogue scorer, else
    through per-user ``predict``."""
    fn = getattr(model, '_score_catalog', None)
    if fn is not None:
        return fn(user_batch)
    return torch.as_tensor(
        np.stack([model.predict(int(u)) for u in user_batch]),
        dtype=torch.float32, device=device)


def _user_scores(model, device):
    """The materialize path's scores of a batch of users, their train rows
    (-1 pads; None: no train set) masked to -FLOAT_MAX."""
    def scores(users, train_rows):
        out = _score_user_batch(model, users, device)
        return out if train_rows is None else _mask_scores(out, train_rows)
    return scores


def _sequence_final_scores(model, prefixes, exclude_preceding, device):
    """(B, num_items) next-item scores for a batch of sequence prefixes,
    through the model's catalogue scorer, else through per-sequence
    ``predict``; items of the prefix masked to -FLOAT_MAX on request."""
    fn = getattr(model, '_score_catalog_sequences', None)
    if fn is not None:
        scores = fn(prefixes)
    else:
        scores = torch.as_tensor(np.stack([model.predict(p)
                                           for p in prefixes]),
                                 dtype=torch.float32, device=device)
    if exclude_preceding:
        scores = _mask_scores(scores, torch.as_tensor(
            prefixes.astype(np.int64), device=device))
    return scores


def _sequence_scores(model, exclude_preceding, device):
    """The materialize path's scores of a batch of prefixes, which masks
    the prefixes themselves (:func:`_sequence_final_scores`)."""
    return lambda prefixes, excluded: _sequence_final_scores(
        model, prefixes, exclude_preceding, device)


def _route(model, streaming, device, fetch=None):
    """Whether one metric call streams: the caller asks for it, the model
    gives the streaming kernels factors (its ``_rank_factor_shape``, the
    factors' ``(dim, mixtures)``, is not None), and the kernels take them
    (``ranking.streams``, or ``topk.streams`` for the call's widest
    top-``fetch``).  Decided once, before any launch; a call the kernels
    refuse counts in MATERIALIZE_ROUTES."""
    global MATERIALIZE_ROUTES
    shape_fn = getattr(model, '_rank_factor_shape', None)
    shape = shape_fn() if streaming and shape_fn is not None else None
    if shape is None:
        return False
    dim, mixtures = shape
    if fetch is None:
        takes = ranking.streams(dim, mixtures, device)
    else:
        takes = topk.streams(fetch, dim, mixtures, device)
    if not takes:
        MATERIALIZE_ROUTES += 1
    return takes


def _resolve_batch_size(batch_size, streaming):
    if batch_size is not None:
        return batch_size
    return STREAMING_BATCH if streaming else MATERIALIZE_BATCH


def _model_device(model):
    """The model's ``_device``; a model without one runs where the
    estimators do by default: ``cuda``, raising when no card is present.
    A caller who wants the CPU says so on the model."""
    device = getattr(model, '_device', None)
    return resolve_device(None) if device is None else device


def _mrr_loop(model, kind, stream, batches, scores):
    """Per-row mean reciprocal ranks of a call's ``batches`` (inputs,
    targets, target mask, excluded rows, widths), on the host: through the
    rank kernel when the call streams, else by sorting ``scores(inputs,
    excluded rows)``."""
    scorer = _scorer(model) if stream else None
    mrrs = []
    for inputs, targets, target_mask, excluded, widths in batches:
        if scorer is None:
            mrrs.append(_reciprocal_ranks(scores(inputs, excluded), targets,
                                          target_mask))
        else:
            mrrs.append(_streaming_ranks(
                scorer, _rank_factors(model, kind, inputs), targets,
                target_mask, excluded, widths))
    return torch.cat(mrrs).cpu().numpy() if mrrs else np.array([])


def _topk_loop(model, kind, stream, batches, scores, k_values):
    """(precision, recall) at each of ``k_values`` of a call's ``batches``,
    each (rows, len(k_values)) on the host: through the top-k kernel when
    the call streams, else by sorting ``scores(inputs, excluded rows)``."""
    scorer = _scorer(model) if stream else None
    k_max = max(k_values)
    precisions, recalls = [], []
    for inputs, targets, target_mask, excluded, _ in batches:
        if scorer is None:
            top_ids = _top_items(scores(inputs, excluded), k_max)
        else:
            top_ids = _streaming_topk_hits(
                scorer, _rank_factors(model, kind, inputs), k_max, excluded)
        precision, recall = _precision_recall_from_topk(
            top_ids, targets, target_mask, k_values)
        precisions.append(precision)
        recalls.append(recall)
    if not precisions:
        # One column whatever k, as the JAX package returns.
        return np.empty((0, 1)), np.empty((0, 1))
    precision, recall = torch.stack(
        [torch.cat(precisions), torch.cat(recalls)]).cpu().numpy()
    return precision, recall


def _eval_rows(test, train):
    """Users with test items, and their test rows and train rows (None
    without ``train``) as ``_Rows``, the ids in each CSR's order."""
    with span('spotlight.eval.rows'):
        test_csr = test.tocsr()
        # The CSR's rows that hold an entry: it keeps every pair, summing
        # duplicates, explicit zeros included.
        users = np.unique(test.user_ids).astype(np.int64)
        targets = _csr_rows(test_csr, users)
        train_rows = (_csr_rows(train.tocsr(), users)
                      if train is not None else None)
    return users, targets, train_rows


def _batches(users, targets, train_rows, batch_size, device):
    """(user ids, targets, target mask, train rows, target counts) per
    batch: the ``_Rows`` padded with -1 to the batch's own widest row,
    built on ``device`` from the real ids."""
    device = torch.device(device)
    train_batches = (train_rows.batches(batch_size)
                     if train_rows is not None else itertools.repeat(None))
    for u, t, tr in zip(_batched(users, batch_size),
                        targets.batches(batch_size), train_batches):
        with span('spotlight.eval.upload'):
            placed = _rows_on([t] if tr is None else [t, tr], device)
        yield (u, placed[0], placed[0] >= 0,
               placed[1] if tr is not None else None, t.counts)


@torch.no_grad()
def mrr_score(model, test, train=None, batch_size=None, streaming=True):
    """Mean reciprocal rank: one score per user with test interactions,
    the mean reciprocal (average-tie) rank of that user's test items.

    Parameters
    ----------
    model : fitted recommender
    test : :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    train : Interactions, optional
        If supplied, train items are ranked below every other item and so
        do not affect the MRR.
    batch_size : int, optional
        Users per batch (default :data:`STREAMING_BATCH` when streaming,
        else :data:`MATERIALIZE_BATCH`).
    streaming : bool, optional
        Rank with the streaming kernels (default) or, if False, by sorting
        a materialised score matrix.

    Returns
    -------
    np.ndarray of shape (num_users_with_test_items,)
    """
    with span('spotlight.mrr_score'):
        users, targets, train_rows = _eval_rows(test, train)
        device = _model_device(model)
        stream = _route(model, streaming, device)
        batches = _batches(users, targets, train_rows,
                           _resolve_batch_size(batch_size, stream), device)
        return _mrr_loop(model, 'users', stream, batches,
                         _user_scores(model, device))


@torch.no_grad()
def precision_recall_score(model, test, train=None, k=10, batch_size=None,
                           streaming=True):
    """Precision@k and recall@k for every user with test interactions.

    Parameters
    ----------
    model : fitted recommender
    test : :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    train : Interactions, optional
        If supplied, train items are excluded from each user's top k.
    k : int or array of int
    batch_size : int, optional
        Users per batch (default :data:`STREAMING_BATCH` when streaming,
        else :data:`MATERIALIZE_BATCH`).
    streaming : bool, optional
        Take the top k with the streaming top-k kernel (default) or, if
        False, by sorting a materialised score matrix.

    Returns
    -------
    (precision, recall) : np.ndarrays of shape (num_users,) for scalar k,
        (num_users, len(k)) for array k.
    """
    with span('spotlight.precision_recall_score'):
        scalar_k = np.isscalar(k)
        k_values = tuple(np.atleast_1d(k).astype(int).tolist())
        if max(k_values) > test.num_items:
            raise ValueError('k ({}) exceeds the catalog size ({})'
                             .format(max(k_values), test.num_items))

        users, targets, train_rows = _eval_rows(test, train)
        device = _model_device(model)
        # The call's widest fetch, k plus its widest train row (a batch's
        # fetch is at most this, and at most the catalogue).
        fetch = max(k_values) + (0 if train_rows is None
                                 else train_rows.width)
        stream = _route(model, streaming, device, fetch)
        batches = _batches(users, targets, train_rows,
                           _resolve_batch_size(batch_size, stream), device)
        precision, recall = _topk_loop(model, 'users', stream, batches,
                                       _user_scores(model, device),
                                       k_values)
        if scalar_k:
            return precision[:, 0], recall[:, 0]
        return precision, recall


def _excluded_rows(prefixes, exclude_preceding):
    """``_Rows`` of each prefix's distinct items in ascending order, in one
    pass over all the prefixes, when ``exclude_preceding``; else None."""
    if not exclude_preceding:
        return None
    sorted_m = np.sort(prefixes.astype(np.int64), axis=1)
    first = np.ones_like(sorted_m, dtype=bool)
    first[:, 1:] = sorted_m[:, 1:] != sorted_m[:, :-1]
    return _Rows(first.sum(axis=1), sorted_m[first])


def _sequence_batches(prefixes, targets, excluded, batch_size, device):
    """(prefixes, targets, target mask, excluded rows, None) per batch:
    the targets on ``device``, every one real, and the batch's
    ``excluded`` ``_Rows`` (None: nothing excluded) padded with -1 to the
    batch's widest row, built on ``device`` as ``_batches`` builds the
    users' rows."""
    device = torch.device(device)
    excluded_batches = (excluded.batches(batch_size)
                        if excluded is not None else itertools.repeat(None))
    for prefix, t, masked in zip(_batched(prefixes, batch_size),
                                 _batched(targets, batch_size),
                                 excluded_batches):
        with span('spotlight.eval.upload'):
            if masked is not None:
                masked, = _rows_on([masked], device)
            t = torch.as_tensor(t.astype(np.int64), device=device)
        yield prefix, t, torch.ones_like(t, dtype=torch.bool), masked, None


@torch.no_grad()
def sequence_mrr_score(model, test, exclude_preceding=False, batch_size=None,
                       streaming=True):
    """MRR of each sequence's last element given all preceding elements.

    Parameters
    ----------
    model : fitted sequence model
    test : :class:`~spotlight_tpu_torch.data.interactions.SequenceInteractions`
    exclude_preceding : bool, optional
        Push items already in the prefix below every other item.  Like the
        JAX package, this also excludes the padding id 0.
    batch_size : int, optional
        Sequences per batch (default :data:`STREAMING_BATCH` when
        streaming, else :data:`MATERIALIZE_BATCH`).
    streaming : bool, optional
        Rank with the streaming kernels (default) or, if False, by sorting
        a materialised score matrix.

    Returns
    -------
    np.ndarray of shape (num_sequences,)
    """
    with span('spotlight.sequence_mrr_score'):
        with span('spotlight.eval.rows'):
            prefixes = test.sequences[:, :-1]
            excluded = _excluded_rows(prefixes, exclude_preceding)
        device = _model_device(model)
        stream = _route(model, streaming, device)
        batches = _sequence_batches(
            prefixes, test.sequences[:, -1:], excluded,
            _resolve_batch_size(batch_size, stream), device)
        return _mrr_loop(model, 'sequences', stream, batches,
                         _sequence_scores(model, exclude_preceding, device))


@torch.no_grad()
def sequence_precision_recall_score(model, test, k=10,
                                    exclude_preceding=False,
                                    batch_size=None, streaming=True):
    """Precision@k = recall@k of each sequence's last ``k`` elements given
    all preceding elements.

    Parameters
    ----------
    model : fitted sequence model
    test : :class:`~spotlight_tpu_torch.data.interactions.SequenceInteractions`
    k : int
    exclude_preceding : bool, optional
        Exclude items already in the prefix (and the padding id 0) from the
        top k.
    batch_size : int, optional
    streaming : bool, optional

    Returns
    -------
    (precision, recall) : np.ndarrays of shape (num_sequences,)
    """
    with span('spotlight.sequence_precision_recall_score'):
        with span('spotlight.eval.rows'):
            prefixes = test.sequences[:, :-k]
            excluded = _excluded_rows(prefixes, exclude_preceding)
        device = _model_device(model)
        # The call's widest fetch, k plus its widest excluded row.
        fetch = k + (0 if excluded is None else excluded.width)
        stream = _route(model, streaming, device, fetch)
        batches = _sequence_batches(
            prefixes, test.sequences[:, -k:], excluded,
            _resolve_batch_size(batch_size, stream), device)
        precision, recall = _topk_loop(
            model, 'sequences', stream, batches,
            _sequence_scores(model, exclude_preceding, device), (k,))
        return precision[:, 0], recall[:, 0]


def rmse_score(model, test):
    """Root mean squared error of the model's rating predictions over the
    test pairs, in float32 when the ratings are float32.

    Parameters
    ----------
    model : fitted explicit model
    test : :class:`~spotlight_tpu_torch.data.interactions.Interactions`

    Returns
    -------
    float
    """
    predictions = model.predict(test.user_ids, test.item_ids)
    return np.sqrt(((test.ratings - predictions) ** 2).mean())
