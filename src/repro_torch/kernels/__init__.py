"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
torch version:

    pricing   — the snapshot bundle: masked price reductions and head-room
                over a (W, H, R) slot stack (replaces the JAX package's
                Pallas ``_pallas_bundle_call``)
    minplus   — the Algorithm-3 min-plus DP sweep, fused into one launch
                (replaces the Pallas ``_pallas_minplus_call`` step)
    rmsnorm   — fused RMSNorm, each row read once in 16-byte chunks
                (replaces the Pallas ``_rmsnorm_kernel``), and its
                backward kernel under ``RMSNormFn`` for training
    flash_attention — forward online-softmax attention over the model's
                (B, S, H, D) layout, grouped kv heads, causal and window
                masks (replaces the Pallas ``_flash_kernel``)
    ops       — the model's routed entry points to the last two

Sources live in ``csrc/``; ``_build`` compiles them with nvcc at first
use and loads them with ctypes. A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.
"""
