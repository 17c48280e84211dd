"""PyTorch/CUDA port of the two-tower retrieval engine, for one NVIDIA H100.

The JAX package beside it (``instacart_next_order_recommendation_tpu``) is
the reference. This package imports neither it nor JAX. Its serve path runs
token ids through hand-written CUDA kernels (``ops/csrc``) to an exact
cosine top-k over a catalog resident on the GPU.
"""
