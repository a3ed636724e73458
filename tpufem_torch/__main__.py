from tpufem_torch.cli import main

main()
