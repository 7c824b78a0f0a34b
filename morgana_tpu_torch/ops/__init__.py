"""Tensor ops of the port: masks, duration upsampling, deltas, the LSTM layer
(kernels K1 and K2 on the GPU), MLPG and the masked sequence losses."""
