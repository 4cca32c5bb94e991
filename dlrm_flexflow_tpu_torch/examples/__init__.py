"""Example applications of the port, run as modules."""
