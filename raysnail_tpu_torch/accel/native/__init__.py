"""The native (C++) BVH builder, compiled with g++ at first use and loaded
with ctypes."""
