"""examples/combustion: the CH4 + 2 O2 mixture and its fragment analysis."""
