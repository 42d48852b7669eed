"""Alias module of the original library's ``spotlight.cross_validation``
path."""

from spotlight_tpu_torch.data.cross_validation import (  # noqa: F401
    random_train_test_split,
    shuffle_interactions,
    user_based_train_test_split,
)
