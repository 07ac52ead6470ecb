"""Step builders."""
