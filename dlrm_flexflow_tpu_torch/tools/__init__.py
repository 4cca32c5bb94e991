"""Development probes of the port, run as modules on a GPU machine."""
