"""Tensor ops of the port: masks, duration upsampling, deltas, the LSTM layer
(kernel K1 on the GPU) and MLPG."""
