"""L0 math core: vectors, RNG, sampling, color (reference: src/prelude/)."""
