// The attend kernel's instances (beam_attend.cuh) on int8 codes with their
// scales, quant (dequantized dots): rv_attend_i8, which beam_step_f.cu's C
// entries call. One source a memory mode, so that nvcc builds the modes in
// parallel.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "beam_attend.cuh"

#define MODE ModeI8
RV_ATTEND_ENTRY(i8)
