"""Label assigners of the port."""
