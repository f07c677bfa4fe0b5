"""The GEMM cost model and tiling search (port of ``repro/core``'s
``tiling``, ``hardware``, ``memory_model``, ``bandwidth`` and ``dse``),
parametric in a hardware sheet: ``HOPPER_H100`` for the port's kernels,
and a copy of ``TPU_V5E`` that the tests hold against the JAX
package."""
