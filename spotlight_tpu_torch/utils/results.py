"""Resumable experiment result logs.

Counterpart of ``spotlight_tpu/utils/results.py``, in the same format: each
experiment run appends one JSON line keyed by the md5 of its
hyperparameter dict serialised as sorted JSON, so an interrupted sweep
resumes where it stopped and a completed configuration is never run again.
The port and the JAX package read and extend one log: a configuration is in
it whichever package wrote it.
"""

from __future__ import annotations

import hashlib
import json
import os


class Results:
    """Append-only JSONL result log, keyed by config hash.

    Usage::

        results = Results('sweep.jsonl')
        for config in param_sampler:
            if config in results:
                continue
            metrics = run(config)
            results.save(config, **metrics)
        best = results.best(key='test_mrr')
    """

    def __init__(self, filename):
        self._filename = filename
        open(self._filename, 'a+').close()

    @staticmethod
    def _hash(config):
        serialized = json.dumps(config, sort_keys=True, default=str)
        return hashlib.md5(serialized.encode('utf-8')).hexdigest()

    def save(self, config, **metrics):
        result = dict(config, hash=self._hash(config), **metrics)
        with open(self._filename, 'a+') as out:
            out.write(json.dumps(result) + '\n')
        return result

    def __iter__(self):
        with open(self._filename, 'r+') as fh:
            for line in fh:
                line = line.strip()
                if line:
                    yield json.loads(line)

    def __contains__(self, config):
        config_hash = self._hash(config)
        return any(row.get('hash') == config_hash for row in self)

    def __getitem__(self, config):
        config_hash = self._hash(config)
        for row in self:
            if row.get('hash') == config_hash:
                return row
        raise KeyError(config)

    def __len__(self):
        return sum(1 for _ in self)

    def best(self, key='test_mrr', maximize=True):
        rows = [row for row in self if key in row]
        if not rows:
            raise KeyError('no results with metric {!r}'.format(key))
        return (max if maximize else min)(rows, key=lambda r: r[key])

    def remove(self, config):
        """Drop a configuration's rows (e.g. to force a re-run)."""
        config_hash = self._hash(config)
        rows = [row for row in self if row.get('hash') != config_hash]
        with open(self._filename, 'w') as out:
            for row in rows:
                out.write(json.dumps(row) + '\n')

    @property
    def filename(self):
        return self._filename

    def __repr__(self):
        return '<Results {} ({} rows)>'.format(
            os.path.basename(self._filename), len(self))
