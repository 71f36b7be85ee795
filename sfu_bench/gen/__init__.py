"""Traffic generators: the seeded synth (frozen from the port) and its cycled library."""
