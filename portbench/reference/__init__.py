"""Plain PyTorch and NumPy references (no `jax`, `repro` or
`repro_torch`).

A configuration names its model's reference by module name
(`"reference": "cnn"` is `portbench.reference.cnn`). A model reference
has:

  spec(cfg)                       [(path, shape)] of the flat parameters,
                                  in the program's flat order
  loss(flat, sp, cfg, x, y, prec) the mean loss of one batch (inputs x,
                                  labels y) at the flat parameters
  forward_flops(cfg)              2 x multiply-adds of one sample's
                                  forward (an image, a token), which the
                                  mfu metrics count from

The round references (`fl_sim`, `pod_round`, `compress`) take the model's
reference as an argument.
"""
