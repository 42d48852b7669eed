"""spotlight_tpu_torch: the PyTorch and CUDA port of spotlight_tpu.

The port runs on an NVIDIA H100: plain tensor code is PyTorch, and every
kernel the JAX package wrote in Pallas for the TPU becomes a kernel written
by hand for Hopper (``ops/kernels/csrc``).  It mirrors the JAX package's
module paths and is held against it; it never imports JAX or the JAX
package.  Ported so far: the serving and evaluation paths of implicit
matrix factorisation (``Interactions``, ``BilinearNet``,
``ImplicitFactorizationModel.predict``, ``mrr_score`` and
``precision_recall_score``) and of LSTM and mixture-of-tastes sequence
models (``SequenceInteractions``, ``ImplicitSequenceModel.predict``,
``sequence_mrr_score`` and ``sequence_precision_recall_score``), bloom
embeddings (``ops.BloomEmbedding``, ``ops.ScaledEmbeddingBag``) as item
layers of sequence models and user and item layers of ``BilinearNet``, and
the kernel entry points ``rank_counts``, ``reciprocal_ranks_streaming``,
``bloom_gather_sum`` and ``multihot_gather_sum`` (``ops.kernels``), and
the training of implicit matrix factorisation
(``ImplicitFactorizationModel.fit``: the dense engine and the row-sparse
lazy-Adam engine, whose row update is the kernel ``row_adam``).
"""

__version__ = '0.1.0'


def __getattr__(name):
    """Top-level access to the main estimators and data types."""
    from importlib import import_module

    homes = {
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
