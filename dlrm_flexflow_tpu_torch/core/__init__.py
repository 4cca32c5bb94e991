"""Graph, tensors, ops and initializers of the port."""
