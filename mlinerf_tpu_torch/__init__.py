"""MLI-NeRF in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX package ``mlinerf_tpu`` that keeps its layout (config,
data, utils, ops, models, trainers). Plain tensor code is PyTorch; the JAX
package's one Pallas kernel, the hash-grid table-gradient scatter-add, is a
hand-written CUDA kernel here (``csrc/scatter_add_rows.cu``). Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
