"""One file per architecture, named by a configuration's ``arch``:

  * ``init_params(cfg, seed, device)`` the starting weights, made from the
    seed on the device in a few large draws, in the tree layout the port's
    ``grad_fn`` takes (the reference reads the same tree);
  * ``flops_per_round(cfg, traffic)`` the model's training FLOPs of one
    gradient tick of every worker, counted from the shapes;
  * ``work_per_round(cfg, traffic)`` and ``WORK_UNIT`` what a tick trains;
  * ``program_grad_fn(cfg, stream)`` the port's batched ``grad_fn`` (the
    only place that imports the port's model code).
"""
