"""Device operators of pythtb_tpu_torch: assembly, eigensolves, grids, Berry links."""
