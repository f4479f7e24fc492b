"""The sines experiments (port of the JAX package's sines_tpu/; reference
sines/): `train_DKT`, `train_FT` and `train_MAML`, each
`python -m deep_kernel_transfer_tpu_torch.sines.<script>`."""
