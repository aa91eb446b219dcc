"""DSG math: projection, dimension-reduction search, masks, CSR patterns."""
