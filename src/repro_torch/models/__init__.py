"""Model code: layers, the dense decoder, family dispatch."""
