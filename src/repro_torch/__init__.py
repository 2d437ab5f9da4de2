"""PyTorch/CUDA port of the loop compiler (`repro`), for NVIDIA Hopper.

`repro_torch.core.compile_program(p).run(inputs)` runs a loop program on
one CUDA device (or on the CPU when asked with device="cpu");
`repro_torch.serve.ServeEngine` serves the LM stack's llama3-8b and
falcon-mamba-7b configs, and `repro_torch.train.make_train_step` with
`repro_torch.runtime.TrainRunner` trains them.  The package imports
torch and numpy, never jax and nothing of `repro`."""
