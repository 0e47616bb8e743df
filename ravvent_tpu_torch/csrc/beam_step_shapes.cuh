// The shapes that the beam step's kernels (beam_cell in beam_step_f.cu,
// beam_attend in beam_attend.cuh and its per-mode sources) are compiled for,
// listed once: the decoder unit counts U and the largest beam width. Each C
// entry refuses any other U and any W outside 1..RV_STEP_MAX_BEAMS, and
// ops/beam_step_cuda.py:STEP_UNITS / STEP_BEAMS read both from the #define
// lines below. A width joins by being added there, where the kernels'
// templates take it (beam_attend.cuh states the rules).

#pragma once

#define RV_STEP_UNITS(X) X(64) X(128) X(256)
#define RV_STEP_MAX_BEAMS 32
