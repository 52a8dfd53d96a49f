"""Forward paths of the port (training comes with a later slice)."""
