"""Built-in example scenes (reference: examples/common/)."""
