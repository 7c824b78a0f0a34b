"""File I/O helpers (counterpart of ``morgana_tpu/data/file_io.py``): JSON,
numeric text, binary ``.npy`` features and id-lists, read and written."""
import json
import os

import numpy as np

__all__ = ['load_json', 'save_json', 'load_txt', 'save_txt', 'load_bin', 'save_bin',
           'save_dir', 'get_file_ids', 'save_lines']


def _make_parent(file_path):
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)


def load_json(file_path):
    with open(file_path, 'r') as f:
        return json.load(f)


def save_json(data, file_path):
    _make_parent(file_path)
    with open(file_path, 'w') as f:
        json.dump(data, f, indent=4)


def save_lines(lines, file_path):
    _make_parent(file_path)
    with open(file_path, 'w') as f:
        for line in lines:
            f.write(f'{line}\n')


def load_txt(file_path):
    """Loads a whitespace-separated numeric text file as float32 (rows = frames)."""
    return np.loadtxt(file_path, dtype=np.float32, ndmin=2)


def save_txt(data, file_path):
    _make_parent(file_path)
    np.savetxt(file_path, np.asarray(data), fmt='%s')


def load_bin(file_path, feat_dim=None, dtype=np.float32):
    """Loads a binary feature file. ``.npy`` files load natively; raw binary
    files need ``feat_dim``."""
    if file_path.endswith('.npy') or not os.path.exists(file_path) and os.path.exists(file_path + '.npy'):
        if not file_path.endswith('.npy'):
            file_path += '.npy'
        return np.load(file_path)
    data = np.fromfile(file_path, dtype=dtype)
    if feat_dim is not None:
        data = data.reshape(-1, feat_dim)
    return data


def save_bin(data, file_path):
    _make_parent(file_path)
    if not file_path.endswith('.npy'):
        file_path += '.npy'
    np.save(file_path, np.asarray(data))


def save_dir(save_fn, path, data, file_ids, suffix=''):
    """Saves each item of ``data`` with ``save_fn`` as
    ``{path}/{file_id}{suffix}`` (``data/file_io.py:79``)."""
    os.makedirs(path, exist_ok=True)
    for datum, file_id in zip(data, file_ids):
        save_fn(datum, os.path.join(path, f'{file_id}{suffix}'))


def get_file_ids(id_list):
    """Loads an id-list file: one base name per line, blanks stripped."""
    with open(id_list, 'r') as f:
        return list(filter(bool, map(str.strip, f.readlines())))
