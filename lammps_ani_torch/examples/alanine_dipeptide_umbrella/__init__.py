"""examples/alanine-dipeptide-umbrella: umbrella windows over a dihedral
and their PMF."""
