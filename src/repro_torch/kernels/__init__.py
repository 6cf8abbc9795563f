"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

  fused_momentum  Triton    replaces repro/kernels/fused_momentum.py
  ef_topk         CUDA C++  replaces repro/kernels/ef_topk.py
                            (csrc/ef_topk.cu, built for sm_90a)
  magnitude_hist  CUDA C++  replaces repro/kernels/magnitude_hist.py
                            (csrc/magnitude_hist.cu, built for sm_90a)
  compact_blocks  CUDA C++  replaces repro/kernels/compact_topk.py
                            (csrc/compact_blocks.cu, built for sm_90a)
  ssd             CUDA C++  replaces no TPU kernel (the reference's
                            SSD is plain jnp): the Mamba-2 layers'
                            chunked SSD, forward and backward, behind
                            models.mamba2.ssd_chunked on a card
                            (csrc/ssd.cu, built for sm_90a)

Each wrapper takes its plain version (`ref.py`; the SSD's beside it in
`ssd.py`) only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises. `ops.py` composes them into the threshold top-k
pipeline and the pod-sync shard compaction.
"""
