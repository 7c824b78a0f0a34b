"""Data pipeline of the port: sources, normalisers, dataset, collate (and
the move of a collated batch to the device), the shuffling loader and the
synthetic corpus writer."""
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.data import sources as data_sources
from morgana_tpu_torch.data.dataset import (FilesDataset, assemble_item, bucket_size, collate,
                                            device_features)
from morgana_tpu_torch.data.loader import DataLoader, batch
from morgana_tpu_torch.data.normalisers import MeanVarianceNormaliser, MinMaxNormaliser
from morgana_tpu_torch.data.sources import NumpyBinarySource, TextSource, _DataSource

__all__ = ['file_io', 'data_sources', 'FilesDataset', 'assemble_item', 'bucket_size', 'collate',
           'device_features', 'DataLoader', 'batch', 'MeanVarianceNormaliser', 'MinMaxNormaliser',
           'NumpyBinarySource', 'TextSource', '_DataSource']
