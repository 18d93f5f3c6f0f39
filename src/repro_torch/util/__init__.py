"""Framework-free helpers (copies of the reference's ``repro.util``)."""
