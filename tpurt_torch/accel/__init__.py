"""Acceleration structures (tpurt/accel): the SAH BVH builder."""
