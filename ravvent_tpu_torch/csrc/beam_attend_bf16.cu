// The attend kernel's instances (beam_attend.cuh) on bf16 keys and values:
// rv_attend_bf16, which beam_step_f.cu's C entries call. One source a memory
// mode, so that nvcc builds the modes in parallel.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "beam_attend.cuh"

#define MODE ModeBf16
RV_ATTEND_ENTRY(bf16)
