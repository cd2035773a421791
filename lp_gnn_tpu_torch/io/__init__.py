"""LP files: MPS and basis (.bas) formats."""
