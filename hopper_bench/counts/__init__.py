"""FLOP and byte counts from shapes, and the table of peaks."""
