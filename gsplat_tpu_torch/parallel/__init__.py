"""Multi-device and multi-process execution: the mesh, the process group,
the sharded render and the scaling report."""
