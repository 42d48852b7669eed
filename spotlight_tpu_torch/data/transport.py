"""Download-and-cache transport for dataset files.

Counterpart of ``spotlight_tpu/data/transport.py``: datasets are cached
under ``~/spotlight_data`` (the ``SPOTLIGHT_DATA_DIR`` environment variable
overrides it).  A pre-populated cache is read as it is; a missing file is
downloaded, or ``IOError`` when ``download_if_missing`` is off.  ``h5py``
and ``requests`` are imported inside the functions that read or fetch a
file, so the package imports without either.
"""

from __future__ import annotations

import os


def data_dir():
    return os.environ.get(
        'SPOTLIGHT_DATA_DIR',
        os.path.join(os.path.expanduser('~'), 'spotlight_data'))


def create_data_dir(path):
    if not os.path.isdir(path):
        os.makedirs(path)


def download(url, dest_path):
    import requests

    req = requests.get(url, stream=True)
    req.raise_for_status()

    with open(dest_path, 'wb') as fd:
        for chunk in req.iter_content(chunk_size=2 ** 20):
            fd.write(chunk)


def get_data(url, dest_subdir, dest_filename, download_if_missing=True):
    dest_dir = os.path.join(os.path.abspath(data_dir()), dest_subdir)
    create_data_dir(dest_dir)

    dest_path = os.path.join(dest_dir, dest_filename)

    if not os.path.isfile(dest_path):
        if download_if_missing:
            download(url, dest_path)
        else:
            raise IOError('Dataset missing.')

    return dest_path


def fetch_hdf5_columns(url, dest_subdir, dest_filename, columns):
    """Download or open an HDF5 dataset file and read the given columns:
    ``tuple(file[column][:] for column in columns)``."""
    import h5py

    path = get_data(url, dest_subdir, dest_filename)
    with h5py.File(path, 'r') as data:
        return tuple(data[column][:] for column in columns)
