"""Mamba2 SSD intra-chunk kernel (csrc/ssd_chunk.cu) and its plain version."""
