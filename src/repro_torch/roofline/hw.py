"""NVIDIA H100 SXM constants (NVIDIA's data sheet, dense rates without
sparsity, at the part's full 700 W power limit): the card the port targets.
They are published figures, not measurements; a card set below 700 W runs
slower under load, so a measured time is stated beside the card's power
limit.

The collective term models one host's NVLink (every card of the host linked
to every other, 450 GB/s each way); links across hosts (InfiniBand or
Ethernet between the two pods of the "multi" mesh) are not modelled.
"""

PEAK_FLOPS_BF16 = 989e12      # per card, bf16 (and fp16) tensor cores
PEAK_FLOPS_TF32 = 495e12      # TF32 tensor cores; 3xTF32 runs 3 per product
PEAK_FLOPS_F32 = 67e12        # float32 outside the tensor cores
PEAK_FLOPS_F64 = 34e12        # float64 outside the tensor cores
PEAK_FLOPS_F64_TENSOR = 67e12  # float64 on the tensor cores
HBM_BW = 3.35e12              # bytes/s per card
HBM_BYTES = 80e9              # 80 GB of HBM3 per card
NVLINK_BW = 450e9             # bytes/s each way, to the host's other cards
SMS = 132                     # streaming multiprocessors
SMEM_PER_BLOCK = 227 * 1024   # dynamic shared memory one block can use
L2_BYTES = 50 * 1024**2       # L2 cache
