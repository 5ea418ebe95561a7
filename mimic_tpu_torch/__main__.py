from .pipeline.cli import main

main()
