"""The MiniLM-class tower, its checkpoint IO and the text encoder."""
