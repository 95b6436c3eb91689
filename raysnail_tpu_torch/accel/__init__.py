"""Acceleration structures: the host BVH build (numpy, or the native C++
builder) that the traversal kernel reads."""
