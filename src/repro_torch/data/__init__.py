"""Host-side data (numpy copies of ``repro.data``) for the port."""
