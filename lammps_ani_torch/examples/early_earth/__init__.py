"""examples/early_earth: the Miller-Urey mixture and its staged campaign."""
