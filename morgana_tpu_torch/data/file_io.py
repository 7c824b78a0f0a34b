"""File I/O helpers (counterpart of ``morgana_tpu/data/file_io.py``): JSON,
numeric text, binary ``.npy`` features, id-lists and 16-bit PCM wavs, read
and written."""
import json
import os
import struct

import numpy as np

__all__ = ['load_json', 'save_json', 'load_txt', 'save_txt', 'load_bin', 'save_bin',
           'save_dir', 'get_file_ids', 'save_lines', 'save_wav', 'load_wav']


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


def save_wav(wav, file_path, sample_rate=16000):
    """Writes a mono 16-bit PCM wav file (no external deps)."""
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    wav = np.asarray(wav)
    if wav.dtype in (np.float32, np.float64):
        # One dtype decision for both clip and scale: floats within ~[-1, 1]
        # are normalised audio (scale to int16); anything wider is already
        # int16-scale (clip only). Both bounds are checked: a wide-range
        # signal with a small positive peak must not be scaled again and
        # wrap in the int16 cast.
        normalised = wav.min() >= -1.5 and wav.max() <= 1.5
        if normalised:
            # Scale by 2^15 (the WavSource load convention): powers of two
            # are exact in float32, so int16 -> float -> int16 round trips
            # bit-exactly, including full-scale -32768.
            wav = np.clip(wav * 32768.0, -32768.0, 32767.0)
        else:
            wav = np.clip(wav, -32768, 32767)
    pcm = wav.astype(np.int16)
    data = pcm.tobytes()
    with open(file_path, 'wb') as f:
        f.write(b'RIFF')
        f.write(struct.pack('<I', 36 + len(data)))
        f.write(b'WAVEfmt ')
        f.write(struct.pack('<IHHIIHH', 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b'data')
        f.write(struct.pack('<I', len(data)))
        f.write(data)


def load_wav(file_path):
    """Reads a mono 16-bit PCM wav file. Returns (wav int16 array, sample_rate)."""
    with open(file_path, 'rb') as f:
        raw = f.read()
    assert raw[:4] == b'RIFF' and raw[8:12] == b'WAVE', 'not a RIFF/WAVE file'
    pos = 12
    sample_rate = None
    data_body = None
    audio_format = bits = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos:pos + 4]
        size = struct.unpack('<I', raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if chunk_id == b'fmt ':
            audio_format, channels, sample_rate = struct.unpack('<HHI', body[:8])
            bits = struct.unpack('<H', body[14:16])[0] if size >= 16 else None
            assert channels == 1, 'only mono wav supported'
        elif chunk_id == b'data':
            data_body = body  # decode after fmt is known (chunk order varies)
        pos += 8 + size + (size % 2)
    if data_body is None:
        raise ValueError(f'{file_path}: no data chunk found')
    if audio_format != 1 or bits != 16:
        # Decoding anything else as int16 would silently produce noise.
        raise ValueError(f'{file_path}: only 16-bit PCM wavs are supported '
                         f'(format tag {audio_format}, {bits} bits); '
                         f'convert first, e.g. sox in.wav -b 16 -e signed out.wav')
    return np.frombuffer(data_body, dtype=np.int16), sample_rate
