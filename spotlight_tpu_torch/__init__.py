"""spotlight_tpu_torch: the PyTorch and CUDA port of spotlight_tpu.

The port runs on an NVIDIA H100: plain tensor code is PyTorch, and every
kernel the JAX package wrote in Pallas for the TPU becomes a kernel written
by hand for Hopper (``ops/kernels/csrc``).  It mirrors the JAX package's
module paths and is held against it; it never imports JAX or the JAX
package.  Ported so far: the implicit matrix-factorisation serving and
evaluation path (``Interactions``, ``BilinearNet``,
``ImplicitFactorizationModel.predict``, ``mrr_score`` and
``precision_recall_score``).
"""

__version__ = '0.1.0'


def __getattr__(name):
    """Top-level access to the main estimators and data types."""
    from importlib import import_module

    homes = {
        'ImplicitFactorizationModel': 'spotlight_tpu_torch.factorization',
        'BilinearNet': 'spotlight_tpu_torch.factorization',
        'Interactions': 'spotlight_tpu_torch.data',
    }
    if name in homes:
        return getattr(import_module(homes[name]), name)
    raise AttributeError(
        'module {!r} has no attribute {!r}'.format(__name__, name))
