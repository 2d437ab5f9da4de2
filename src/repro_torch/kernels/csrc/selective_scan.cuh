// The checkpoint interval of the fused scan, shared by its forward
// (csrc/selective_scan.cu), whose checkpoint entry writes the state before
// every kCkpt steps, and its backward (csrc/selective_scan_bwd.cu), which
// recomputes kCkpt-step chunks from those states.  The Python wrapper reads
// it from the forward's library (selective_scan_ckpt_steps) to size the
// states buffer.
#pragma once

constexpr int kCkpt = 16;
