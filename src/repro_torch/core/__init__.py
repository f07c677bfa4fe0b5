"""The paper's models and the cost models of the port.

* :mod:`~repro_torch.core.paper_model` / :mod:`~repro_torch.core.paper_tables`
  — the paper's FPGA analytical models and its published Tables II-IV
  (copies of the JAX package's).
* :mod:`~repro_torch.core.tiling` / :mod:`~repro_torch.core.memory_model` /
  :mod:`~repro_torch.core.bandwidth` / :mod:`~repro_torch.core.dse` — the
  GEMM cost model and tiling search (port of ``repro/core``'s), parametric
  in a hardware sheet (:mod:`~repro_torch.core.hardware`): ``HOPPER_H100``
  for the port's kernels, and a copy of ``TPU_V5E`` that the tests hold
  against the JAX package.
* :mod:`~repro_torch.core.op_cost` / :mod:`~repro_torch.core.roofline` —
  a step's FLOPs, device-memory bytes, collective bytes and peak memory
  counted op by op (at each kernel's boundary), and the three-term
  roofline priced on ``HOPPER_H100`` (counterparts of ``hlo_cost`` and
  ``roofline``).
"""
