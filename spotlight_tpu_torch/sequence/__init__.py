"""Sequence models: representations and the implicit sequence estimator."""

from spotlight_tpu_torch.sequence.implicit import (  # noqa: F401
    ImplicitSequenceModel,
)
from spotlight_tpu_torch.sequence.representations import (  # noqa: F401
    PADDING_IDX,
    CNNNet,
    LSTMNet,
    MixtureLSTMNet,
    PoolNet,
    SelfAttentionNet,
)
