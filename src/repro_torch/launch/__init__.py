"""Device meshes and rank processes (``launch.mesh``)."""
