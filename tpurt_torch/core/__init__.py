"""Core math: u32 RNG, SoA 3-vectors, vec math, camera rays."""
