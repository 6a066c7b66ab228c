"""Device resolution, weight interop and experiment folders."""
