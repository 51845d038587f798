"""Shading, tonemap, the megakernel (plain torch version + CUDA kernel)
and the flat renderer."""
