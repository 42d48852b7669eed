"""The lazy engine's learning gates, seed by seed, in both packages.

``tests/test_lazy_adam.py::test_lazy_implicit_learns`` holds the JAX lazy
engine at one model seed (42); ``tests/test_torch_training.py`` holds the
port's bpr gate by the mean over the model seeds 0-3, because the two
packages draw from different random streams and the bpr gate sits inside
the spread of either.  This script prints the readings that choice rests
on: the test MRR of each package at each model seed, on the gate's data
(``generate_factorization(120, 90, 6000)`` seeded 42, split by
``RandomState(0)``), both on the CPU.

    python -m tests.torch_gate_seeds [--seeds 0-7,42] [--loss bpr]
"""

import argparse
import json
import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import numpy as np  # noqa: E402

GATES = {'bpr': (20, 0.05), 'adaptive_hinge': (10, 0.04)}


def seeds_arg(text):
    seeds = []
    for part in text.split(','):
        low, _, high = part.partition('-')
        seeds.extend(range(int(low), int(high or low) + 1))
    return seeds


def jax_reading(loss, n_iter, seed):
    from spotlight_tpu.data import random_train_test_split
    from spotlight_tpu.data.synthetic import generate_factorization
    from spotlight_tpu.evaluation import mrr_score
    from spotlight_tpu.factorization import ImplicitFactorizationModel

    data = generate_factorization(120, 90, 6000,
                                  random_state=np.random.RandomState(42))
    train, test = random_train_test_split(
        data, random_state=np.random.RandomState(0))
    model = ImplicitFactorizationModel(
        loss=loss, n_iter=n_iter, batch_size=512, sparse=True,
        random_state=np.random.RandomState(seed)).fit(train)
    return float(mrr_score(model, test, train=train).mean())


def port_reading(loss, n_iter, seed):
    from spotlight_tpu_torch.data import random_train_test_split
    from spotlight_tpu_torch.data.synthetic import generate_factorization
    from spotlight_tpu_torch.evaluation import mrr_score
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel

    data = generate_factorization(120, 90, 6000,
                                  random_state=np.random.RandomState(42))
    train, test = random_train_test_split(
        data, random_state=np.random.RandomState(0))
    model = ImplicitFactorizationModel(
        loss=loss, n_iter=n_iter, batch_size=512, sparse=True,
        random_state=np.random.RandomState(seed), device='cpu').fit(train)
    return float(mrr_score(model, test, train=train).mean())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seeds', type=seeds_arg, default=seeds_arg('0-7,42'))
    parser.add_argument('--loss', choices=sorted(GATES), nargs='+',
                        default=sorted(GATES))
    args = parser.parse_args()
    for loss in args.loss:
        n_iter, gate = GATES[loss]
        readings = {name: {seed: fn(loss, n_iter, seed) for seed in args.seeds}
                    for name, fn in (('jax', jax_reading),
                                     ('port', port_reading))}
        for name, by_seed in readings.items():
            values = list(by_seed.values())
            print(json.dumps({
                'loss': loss, 'epochs': n_iter, 'gate': gate,
                'package': name, 'mrr_by_seed': by_seed,
                'min': min(values), 'max': max(values),
                'mean': float(np.mean(values)),
                'below_gate': [s for s, v in by_seed.items() if v <= gate]}),
                flush=True)


if __name__ == '__main__':
    main()
