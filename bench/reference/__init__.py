"""Plain references: PyTorch and NumPy only, nothing of the measured
package, nothing it made. They work every compared output out again from
the inputs the benchmark hands to both sides."""
