// The attend kernel's instances of 32 beams (beam_attend.cuh; W = 17-32) on
// bf16 keys and values: rv_attend_bf16_w32, which beam_attend_bf16.cu's
// rv_attend_bf16 calls past 16 beams. A source of their own, so that nvcc
// builds them beside the mode's other instances.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "beam_attend.cuh"

#define MODE ModeBf16
RV_ATTEND_WIDE_ENTRY(bf16)
