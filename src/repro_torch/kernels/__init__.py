"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``) of the paper's
compute hot-spots and of the LM side, one per Pallas TPU kernel of the
JAX package:

  knn_topk   — fused tile-skipping score → streaming top-k
               (``csrc/knn_topk.cu``, ``knn_topk_fused``)
  knn_score  — tile-skipping blocked score product (``csrc/knn_score.cu``,
               ``knn_score_cuda``)
  topk_merge — streaming top-k candidate-set insert (``csrc/topk_merge.cu``,
               ``topk_merge_cuda``): every block step of the drivers, the
               store's tree merges and every step of the ring join
  flash_attn — online-softmax attention, 3xTF32 (f32) and bf16 mma.sync
               (``csrc/flash_attn.cu``, ``flash_attention_cuda``)
  wkv        — chunked RWKV6 time mix (``csrc/wkv.cu``, ``wkv_cuda``)

Each subpackage: kernel.py (the wrapper that launches the kernel on CUDA
tensors and counts its launches, ``.launches``), ops.py (the public op),
ref.py (the plain PyTorch version, which the wrapper runs on CPU
tensors).  ``_build.py`` compiles every ``csrc/*.cu`` with nvcc at the
first use of any kernel; nothing is built on import.
"""
