"""L3 geometry: batched SoA primitive intersectors (reference: src/hittable/)."""
