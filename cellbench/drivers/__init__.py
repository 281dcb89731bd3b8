"""Traffic drivers: the serving loops a mix's ``driver`` names."""
