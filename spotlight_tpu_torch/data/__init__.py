"""Data containers and splits."""

from spotlight_tpu_torch.data.interactions import (  # noqa: F401
    Interactions,
    PADDING_IDX,
)
from spotlight_tpu_torch.data.cross_validation import (  # noqa: F401
    random_train_test_split,
    shuffle_interactions,
    user_based_train_test_split,
)
