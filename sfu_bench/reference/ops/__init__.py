"""The reference's plain ops, frozen from the port's ops/ (see each file)."""
