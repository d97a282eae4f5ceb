"""The model substrate of the port: every family, served and trained."""
