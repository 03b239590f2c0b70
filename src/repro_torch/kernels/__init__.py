"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``kernels.morph_matmul`` — width-gated projection (``csrc/morph_matmul.cu``).
* ``kernels.fused_decode`` — one attention layer of one-token decode and of
  the speculative verify pass (``csrc/fused_decode.cu``,
  ``csrc/fused_verify.cu``, plus the morph_matmul kernel).
* ``kernels.ssd_scan`` — the Mamba2 SSD scan of the SSM prompt pass
  (``csrc/ssd_scan.cu``); ``kernels.ops.ssd_scan_bshn`` is its model-layout
  entry point.
* ``kernels.flash_attention`` — tiled causal / sliding-window GQA attention
  of the dense prompt pass under ``attn_impl="chunked"``
  (``csrc/flash_attention.cu``); ``kernels.ops.flash_attention_bshd`` is its
  model-layout entry point.
* ``kernels.flash_decode`` — single-token attention over a float or int8
  cache (``csrc/flash_decode.cu``); its own entry point, as in the
  reference, which has no model caller for it.

Every Pallas kernel of the reference has its counterpart here. The
submodules are not re-exported: a function named like its module would
shadow the module.
"""
