"""Config loading and experiment directories (mirrors ``ssp/utils``)."""
