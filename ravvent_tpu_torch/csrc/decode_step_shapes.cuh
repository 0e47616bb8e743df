// The shapes that the greedy decode step's kernel (decode_step.cu) is
// compiled for, listed once: the decoder unit counts U and the memory widths
// E (enc_out_dim: 2 x a BiLSTM's units, or a unidirectional encoder's). The
// C entry instantiates the kernel for every (U, E) pair and refuses any
// other; ops/decode_step_cuda.py:GREEDY_UNITS / GREEDY_MEMORY_DIMS read both
// from the #define lines below. A width joins by being added there, where the
// kernel's template takes it (decode_step.cu states the rules).

#pragma once

#define RV_GREEDY_UNITS(X) X(64) X(128) X(256)
#define RV_GREEDY_MEMORY_DIMS(X) X(64) X(128) X(256) X(512)
