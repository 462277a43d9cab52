"""Device segment mirror and ranking weight schemes (torch port)."""
