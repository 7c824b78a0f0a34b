"""Tensor ops of the port: masks, duration upsampling, deltas, the LSTM layer
(kernels K1 and K2 on the GPU), the GRU layer (kernels K3 and K4), MLPG and
the masked sequence losses."""
