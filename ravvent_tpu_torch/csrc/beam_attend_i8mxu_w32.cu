// The attend kernel's instances of 32 beams (beam_attend.cuh; W = 17-32) on
// int8 codes with their scales, quant_mxu (s8 x s8 -> s32 dots):
// rv_attend_i8mxu_w32, which beam_attend_i8mxu.cu's rv_attend_i8mxu calls
// past 16 beams. A source of their own, so that nvcc builds them beside the
// mode's other instances.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "beam_attend.cuh"

#define MODE ModeI8Mxu
RV_ATTEND_WIDE_ENTRY(i8mxu)
