"""Weight conversion between the reference's variable tree and the port."""
