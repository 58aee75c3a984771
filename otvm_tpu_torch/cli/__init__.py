"""Command-line entry points of the port: `python -m otvm_tpu_torch.cli.eval`,
`... .cli.train` and `... .cli.train_s1_trimap` (eval.py, train.py and
train_s1_trimap.py of the JAX package, with their flags)."""
