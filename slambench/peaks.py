"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit), against which the rooflines are taken."""

HBM_BYTES_PER_S = 3.35e12
# a nearest-neighbour call writes, for each query, an int64 index and an
# f32 squared distance
NN_OUT_BYTES = 12.0
