"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``kernels.morph_matmul`` — width-gated projection (``csrc/morph_matmul.cu``).
* ``kernels.fused_decode`` — one attention layer of one-token decode and of
  the speculative verify pass (``csrc/fused_decode.cu``,
  ``csrc/fused_verify.cu``, plus the morph_matmul kernel).
* ``kernels.ssd_scan`` — the Mamba2 SSD scan of the SSM prompt pass
  (``csrc/ssd_scan.cu``); ``kernels.ops.ssd_scan_bshn`` is its model-layout
  entry point.

The submodules are not re-exported here: a function named like its module
would shadow the module. ``flash_attention`` and ``flash_decode`` are still
to be ported.
"""
