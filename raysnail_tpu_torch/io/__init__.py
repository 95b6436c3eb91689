"""IO: OBJ mesh loading."""
