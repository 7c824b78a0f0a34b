"""Data pipeline of the port: sources, normalisers, dataset, collate, the
native batch reader, the shuffling loader and its device prefetch, the
device-side normalisation, the device-resident corpus cache and the
synthetic corpus writer."""
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.data import sources as data_sources
from morgana_tpu_torch.data.dataset import (DeviceBatch, FilesDataset, assemble_item, bucket_size,
                                            collate, device_features, host_features)
from morgana_tpu_torch.data.loader import DataLoader, ToDeviceWrapper, batch, load_items
from morgana_tpu_torch.data.normalisers import (MeanVarianceNormaliser, MinMaxNormaliser,
                                                Normalisers,
                                                SpeakerDependentMeanVarianceNormaliser,
                                                SpeakerDependentMinMaxNormaliser)
from morgana_tpu_torch.data.sources import (ASCIISource, NumpyBinarySource, StringSource,
                                            SyntheticSource, TextSource, WavSource, _DataSource)

__all__ = ['file_io', 'data_sources', 'DeviceBatch', 'FilesDataset', 'assemble_item',
           'bucket_size', 'collate', 'device_features', 'host_features', 'DataLoader',
           'ToDeviceWrapper', 'batch', 'load_items', 'MeanVarianceNormaliser', 'MinMaxNormaliser',
           'Normalisers', 'SpeakerDependentMeanVarianceNormaliser',
           'SpeakerDependentMinMaxNormaliser', 'ASCIISource', 'NumpyBinarySource',
           'StringSource', 'SyntheticSource', 'TextSource', 'WavSource', '_DataSource']
