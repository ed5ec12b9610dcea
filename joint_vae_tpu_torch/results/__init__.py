"""Results / reporting: result tables, aggregation, LaTeX export."""
