"""Host-side utilities: IDs, time, logging, small data structures."""
