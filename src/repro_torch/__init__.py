"""PyTorch/CUDA port of the loop compiler (`repro`), for NVIDIA Hopper.

`repro_torch.core.compile_program(p).run(inputs)` runs a loop program on
one CUDA device (or on the CPU when asked with device="cpu").  The package
imports torch and numpy, never jax and nothing of `repro`."""
