# -*- coding: utf-8 -*-
# Stateless numeric kernels on torch tensors, and the hand-written CUDA
# kernels behind them (csrc/).
