"""One module per loop a traffic mix names."""
