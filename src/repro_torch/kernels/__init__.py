"""Hand-written Hopper kernels for the port's hot spots.

Each kernel directory ships:

* ``ref.py``    — the plain PyTorch version (any device; the CPU tests and
  the on-card comparisons use it);
* ``csrc/``     — the CUDA C++ sources, compiled for ``sm_90a`` at first use;
* ``kernel.py`` — the build, the ctypes bindings and the launch counters;
* ``ops.py``    — the public ops: the kernel for CUDA tensors, the plain
  version for CPU tensors, nothing else.

``_build.py`` compiles every package's ``csrc/`` with ``nvcc``.

Kernels:

* ``policy_scan`` — columnar predicate-program evaluation with fused
  first-match-wins attribution and aggregation (the paper's DB table scan,
  C1+C6);
* ``profile_cube`` — fused bucketize + segment-reduce of the catalog
  columns into the (measure, group, size bucket, age bucket) cube behind
  every ``rbh-report`` query (C6);
* ``paged_attention`` — decode attention over the policy-tiered KV cache's
  pages through a page table, grouped query heads, online softmax (the
  serving engine's hot spot);
* ``rglru_scan`` — the RG-LRU diagonal linear recurrence of
  recurrentgemma's recurrent layers (prefill and every decode step);
* ``rwkv6_step`` — RWKV6's decode-step state update and readout.
"""
