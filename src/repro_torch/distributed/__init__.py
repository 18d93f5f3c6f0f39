"""The pod half of the reference's distributed substrate, on one card."""
