"""Estimator serialization in the port, on the CPU.

The counterparts of ``tests/test_serialization.py`` (implicit and explicit
factorization, the sequence model with each of its four representations)
and of the pickle half of ``tests/test_lazy_adam.py:416``: ``save`` then
``load`` must give exactly the same metric, and the loaded model must
resume training where the saved one stopped: a ``fit`` of the loaded model
and a ``fit`` of the saved one end in the same parameters, bit for bit
(parameters, optimizer state, step count and random stream all
survived).
"""

import io
import pickle

import numpy as np
import pytest
import torch

from spotlight_tpu_torch.data import (SequenceInteractions,
                                      random_train_test_split,
                                      user_based_train_test_split)
from spotlight_tpu_torch.data.synthetic import (generate_factorization,
                                                generate_sequential)
from spotlight_tpu_torch.evaluation import (mrr_score, rmse_score,
                                            sequence_mrr_score)
from spotlight_tpu_torch.factorization import (ExplicitFactorizationModel,
                                               ImplicitFactorizationModel)
from spotlight_tpu_torch.sequence import ImplicitSequenceModel
from spotlight_tpu_torch.utils import serialization, training


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Many small ops: on one thread each, they do not wait on the other
    test workers' threads for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def roundtrip(model):
    buffer = io.BytesIO()
    serialization.save(model, buffer)
    buffer.seek(0)
    return serialization.load(buffer)


def assert_resumes_alike(model, loaded, data):
    """A further ``fit`` of each ends in the same state, bit for bit."""
    model.fit(data)
    loaded.fit(data)
    for name, value in model._net.state_dict().items():
        assert torch.equal(value, loaded._net.state_dict()[name]), name


def factorization_split(explicit=False):
    data = generate_factorization(200, 150, 8000, explicit=explicit,
                                  random_state=np.random.RandomState(42))
    return random_train_test_split(data,
                                   random_state=np.random.RandomState(0))


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'lazy'])
def test_implicit_factorization_roundtrip(sparse):
    train, test = factorization_split()
    model = ImplicitFactorizationModel(
        loss='bpr', n_iter=2, sparse=sparse, device='cpu',
        random_state=np.random.RandomState(42)).fit(train)
    loaded = roundtrip(model)
    np.testing.assert_array_equal(mrr_score(loaded, test, train=train),
                                  mrr_score(model, test, train=train))
    assert loaded._lazy == sparse
    before = loaded._net.user_embeddings.weight.clone()
    assert_resumes_alike(model, loaded, train)
    assert not torch.equal(loaded._net.user_embeddings.weight, before)


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'lazy'])
def test_explicit_factorization_roundtrip(sparse):
    train, test = factorization_split(explicit=True)
    model = ExplicitFactorizationModel(
        n_iter=2, sparse=sparse, device='cpu',
        random_state=np.random.RandomState(42)).fit(train)
    loaded = roundtrip(model)
    assert rmse_score(loaded, test) == rmse_score(model, test)
    assert_resumes_alike(model, loaded, train)


def sequence_split():
    data = generate_sequential(num_users=50, num_items=60,
                               num_interactions=3000,
                               concentration_parameter=0.01,
                               random_state=np.random.RandomState(42))
    train, test = user_based_train_test_split(
        data, random_state=np.random.RandomState(0))
    return (train.to_sequence(max_sequence_length=10),
            test.to_sequence(max_sequence_length=10))


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'lazy'])
@pytest.mark.parametrize('representation', ['pooling', 'lstm', 'cnn',
                                            'mixture'])
def test_sequence_roundtrip(representation, sparse):
    train, test = sequence_split()
    model = ImplicitSequenceModel(
        representation=representation, n_iter=2, sparse=sparse,
        device='cpu', random_state=np.random.RandomState(42)).fit(train)
    loaded = roundtrip(model)
    assert loaded._lazy == sparse
    np.testing.assert_array_equal(sequence_mrr_score(loaded, test),
                                  sequence_mrr_score(model, test))
    np.testing.assert_array_equal(loaded.predict(test.sequences[0]),
                                  model.predict(test.sequences[0]))
    assert_resumes_alike(model, loaded, train)


def test_lazy_sequence_resume_and_pickle():
    """``tests/test_lazy_adam.py:416``: ``t`` doubles on a second ``fit``;
    a pickled clone predicts the same and resumes from there."""
    rs = np.random.RandomState(3)
    sequences = rs.randint(1, 60, size=(256, 8))
    data = SequenceInteractions(sequences, num_items=60)
    model = ImplicitSequenceModel(
        loss='bpr', representation='lstm', embedding_dim=16, n_iter=2,
        batch_size=64, sparse=True, device='cpu',
        random_state=np.random.RandomState(0))
    model.fit(data)
    t_after = model._opt_state['t']
    model.fit(data)
    assert model._lazy and model._opt_state['t'] == 2 * t_after
    clone = pickle.loads(pickle.dumps(model))
    np.testing.assert_array_equal(clone.predict(sequences[0]),
                                  model.predict(sequences[0]))
    clone.fit(data)
    assert clone._opt_state['t'] == 3 * t_after
    assert clone._opt_state['tower']['count'] == 3 * t_after


def test_save_and_load_through_a_path(tmp_path):
    """``save`` and ``load`` take a path as well as a file; the optimizer,
    the cached epoch functions and item factors are rebuilt, and the random
    stream travels as the generator's state."""
    train, test = sequence_split()
    model = ImplicitSequenceModel(
        representation='cnn', n_iter=1, device='cpu',
        random_state=np.random.RandomState(1)).fit(train)
    sequence_mrr_score(model, test)
    assert model._item_factor_cache is not None and model._epoch_fn_cache
    path = tmp_path / 'model.pkl'
    serialization.save(model, str(path))
    loaded = serialization.load(str(path))
    assert loaded._item_factor_cache is None and loaded._epoch_fn_cache == {}
    assert isinstance(loaded._optimizer, training.Adam)
    assert isinstance(loaded._generator, torch.Generator)
    assert torch.equal(loaded._generator.get_state(),
                       model._generator.get_state())
    assert loaded._device == model._device
    np.testing.assert_array_equal(sequence_mrr_score(loaded, test),
                                  sequence_mrr_score(model, test))


def test_an_unfitted_model_roundtrips():
    model = ImplicitFactorizationModel(device='cpu',
                                       random_state=np.random.RandomState(0))
    loaded = roundtrip(model)
    assert not loaded._initialized and loaded._optimizer is None
    train, _ = factorization_split()
    assert loaded.fit(train) is loaded
