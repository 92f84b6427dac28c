"""The table of peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data
sheet, at its full 700 W power limit. A share of a peak is stated against
these, with the card's power limit beside it."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_S = 3.35e12
