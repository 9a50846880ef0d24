"""The port's command-line entry points, twins of the JAX package's root
`cli/` scripts with the same flags, defaults, printed lines and output
files, plus `--device` (the card unless given `cpu`):

  python -m fseend_tpu_torch.cli.train --configs configs/ls_simu.yaml
  python -m fseend_tpu_torch.cli.infer --configs configs/ls_infer.yaml --wav x.wav --ckpt avg_model.npz
  python -m fseend_tpu_torch.cli.streaming_infer / serve / export / score / sad_postprocess / stb_eval / convert

Each module has a `main(argv=None)` that can also be called in process.
"""
