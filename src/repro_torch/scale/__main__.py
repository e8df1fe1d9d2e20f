from repro_torch.scale import main

if __name__ == "__main__":
    main()
