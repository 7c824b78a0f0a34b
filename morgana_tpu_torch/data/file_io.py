"""File I/O helpers (counterpart of ``morgana_tpu/data/file_io.py``): JSON,
numeric text, binary ``.npy`` features and id-lists."""
import json
import os

import numpy as np

__all__ = ['load_json', 'load_txt', 'load_bin', 'get_file_ids']


def load_json(file_path):
    with open(file_path, 'r') as f:
        return json.load(f)


def load_txt(file_path):
    """Loads a whitespace-separated numeric text file as float32 (rows = frames)."""
    return np.loadtxt(file_path, dtype=np.float32, ndmin=2)


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


def get_file_ids(id_list):
    """Loads an id-list file: one base name per line, blanks stripped."""
    with open(id_list, 'r') as f:
        return list(filter(bool, map(str.strip, f.readlines())))
