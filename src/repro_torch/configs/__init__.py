"""Architecture configurations the port serves."""
